"""Multi-device scale: the mesh, sharded search, sharded IVF and training.

Port of ``intelligent_video_analysis_retrieval_system_tpu/parallel``: the
embedding rows shard over a device mesh (``mesh.py``), every shard runs the
single-device search (kernels B1 and B2 on a card) and one merge combines
their candidates (``sharded_search.py``); the IVF mode partitions its
buckets over the same shards (``sharded_ann.py``); a process group spans
hosts (``distributed.py``). This replaces the reference's LAN fan-out of
queries to peer nodes. ``train.py`` (``CLIPTrainer``, ``TrainConfig``)
fine-tunes the CLIP towers contrastively with data and tensor parallelism
over a ``("data", "model")`` mesh, in one process or across the ranks of a
process group (``collectives.py``: the differentiable collectives that take
the place of the one-process moves between devices).
"""

from .mesh import Mesh, MeshSpec, create_mesh, device_info
from .sharded_ann import ShardedIVF, make_sharded_ivf, sharded_ivf_topk
from .sharded_search import ShardedIndexSearcher, sharded_topk
from .train import CLIPTrainer, TrainConfig

__all__ = [
    "Mesh",
    "MeshSpec",
    "create_mesh",
    "device_info",
    "ShardedIndexSearcher",
    "ShardedIVF",
    "make_sharded_ivf",
    "sharded_ivf_topk",
    "sharded_topk",
    "CLIPTrainer",
    "TrainConfig",
]
