"""Device-level parallelism of the port: the device mesh (``mesh.py``),
spatially sharded and column-parallel serving (``spatial.py``,
``tensor.py``) and the uncertainty pipeline (``pipeline.py``)."""
