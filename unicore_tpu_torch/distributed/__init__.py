"""The training plane's fault injection and graceful stop (counterpart of
``unicore_tpu/distributed/``, at world size 1): ``chaos.py`` and the stop
half of ``guard.py``.  Cross-host collectives, the consistency guard and
the elastic run control wait for the parallelism slice."""
