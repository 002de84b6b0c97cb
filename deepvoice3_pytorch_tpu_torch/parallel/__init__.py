# coding: utf-8
from . import mesh  # noqa: F401
from .mesh import make_mesh, shard_batch, shard_params, batch_sharding  # noqa: F401
