"""The distributed runtime and the training plane's fault injection and
graceful stop (counterpart of ``unicore_tpu/distributed/``): ``utils.py``
(the process group, ``call_main``'s spawn, the rank queries and host
collectives of data parallelism), ``chaos.py``, the stop half of
``guard.py`` (its flag agreed across the ranks) and the heartbeat-lease
plane of ``elastic.py`` (which the serving fleet's membership rides).  The
consistency guard, the collective watchdog and the elastic run control are
not ported (ROADMAP queue A item 4)."""
