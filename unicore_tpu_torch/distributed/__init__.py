"""The training plane's fault injection and graceful stop (counterpart of
``unicore_tpu/distributed/``, at world size 1): ``chaos.py``, the stop
half of ``guard.py`` and the heartbeat-lease plane of ``elastic.py`` (which
the serving fleet's membership rides).  Cross-host collectives, the
consistency guard and the elastic run control wait for the parallelism
slice."""
