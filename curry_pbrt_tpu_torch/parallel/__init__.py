"""Inverse rendering (the train step) and ray sharding over processes
(torch.distributed: mesh.py; the launcher, multihost.py)."""
