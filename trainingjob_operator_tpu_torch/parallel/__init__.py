"""Multi-process training for the port: the mesh (``mesh.py``), the
sharding rules and blocks (``sharding.py``), the collectives of a sharded
step and the ring exchange (``collectives.py``), ring attention over the
sequence axis (``ringattention.py``) and the GPipe pipeline over the
stage axis (``pipeline.py``); counterparts of the JAX package's
``parallel/`` modules of the same names."""
