"""Multi-process training for the port: the mesh (``mesh.py``), the
sharding rules and blocks (``sharding.py``) and the collectives of a
sharded step (``collectives.py``); counterparts of the JAX package's
``parallel/`` modules of the same names."""
