"""Multi-process parallelism of the port: the process group
(``distributed``), the dp x sp x tp mesh (``mesh``), the DiT's
tensor-parallel layout and token shards (``sharding``) and the VAE's
spatial slabs over the dp x sp plane (``spatial``)."""
