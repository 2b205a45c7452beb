"""Worlds sharded over processes (one card each) with torch.distributed.

Port of ``madrona_tpu/parallel``: ``mesh`` places a sim's worlds, one
contiguous slice a process; ``distributed`` joins the process group
(NCCL on the card, gloo on the CPU) and measures weak scaling.
"""

from . import distributed, mesh

__all__ = ["distributed", "mesh"]
