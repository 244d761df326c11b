"""The meshes: devices (``mesh.py``), halo exchange and the banded U-Net
(``halo.py``), and the exact chain's segments, one-band or banded
(``sharded_scene.py``)."""
