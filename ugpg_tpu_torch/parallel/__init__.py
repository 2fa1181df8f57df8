"""Device-level parallelism of the port: the device mesh (``mesh.py``),
spatially sharded and column-parallel serving (``spatial.py``,
``tensor.py``), the uncertainty pipeline (``pipeline.py``) and training
over several processes (``distributed.py``)."""
