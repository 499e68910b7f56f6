"""What the tests build from: the JAX benchmark's configuration
(``flagship.py``), the two configurations of the optimizer, stem and Fire
slice (``slice10.py``) and a KITTI devkit tree of synthetic drives
(``kitti_tree.py``)."""
