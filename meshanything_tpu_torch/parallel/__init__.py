"""Multi-process data and tensor parallelism over ``torch.distributed``
(the port of ``meshanything_tpu/parallel/``): ``mesh`` (the (data, model)
grid of ranks and the parameters' sharding), ``collectives``,
``multihost`` (``--multihost`` folder runs), ``launch`` (ranks on this
machine) and ``dryrun``."""
