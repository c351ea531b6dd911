"""Data and tensor parallelism over a mesh of devices (``mesh.py``,
``tp.py``)."""
