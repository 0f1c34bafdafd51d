"""Multi-process parallelism of the port: the process group
(``distributed``), the dp x sp x tp mesh (``mesh``) and the DiT's
tensor-parallel layout and token shards (``sharding``)."""
