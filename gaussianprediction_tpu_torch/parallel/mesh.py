"""The ('data', 'tile') mesh of ranks: the twin of the JAX package's
parallel/mesh.py on torch.distributed.

'data' splits the camera batch (each data group trains on its own
camera), 'tile' splits each frame into bands of tile rows; the Gaussians
are replicated and their gradients summed over the whole mesh. Rank r of
the mesh sits at (r // n_tile, r % n_tile), the row-major layout of the
JAX mesh's device array.

The JAX module's replicated() and data_sharded() return NamedShardings,
placements of one global array over devices. A torch process owns its
tensors, so they have no counterpart here: the sharded step
(parallel/shard.py) keeps the state replicated on every rank and picks
its data group's camera by Mesh.data_index.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    n_data: int
    n_tile: int
    ranks: List[int]          # the mesh's ranks in the default group
    rank: int                 # this process's rank in the default group
    data_index: int           # this rank's coordinate on 'data'
    tile_index: int           # ... and on 'tile'
    group: object             # the process group of the whole mesh
    tile_group: object        # this rank's ranks of one data group
    data_group: object        # this rank's ranks of one tile index

    @property
    def shape(self):
        return {"data": self.n_data, "tile": self.n_tile}


def mesh_ranks(n_data: int, n_tile: int, ranks: Sequence[int]):
    """([tile groups], [data groups]): tile group d holds mesh positions
    (d, 0..n_tile-1), data group k the positions (0..n_data-1, k)."""
    ranks = list(ranks)
    tiles = [ranks[d * n_tile:(d + 1) * n_tile] for d in range(n_data)]
    datas = [ranks[k::n_tile] for k in range(n_tile)]
    return tiles, datas


def make_mesh(n_data: int = 1, n_tile: Optional[int] = None,
              ranks: Optional[Sequence[int]] = None) -> Optional[Mesh]:
    """Build the mesh over `ranks` of the default group (default: every
    rank; n_tile defaults to len(ranks) // n_data), the first n_data *
    n_tile of them in row-major order. Every rank of the default group
    must call it (torch.distributed.new_group's rule); ranks outside the
    mesh get None."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel/distributed.py)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if n_tile is None:
        n_tile = len(ranks) // n_data
    if n_data < 1 or n_tile < 1 or n_data * n_tile > len(ranks):
        raise ValueError(f"a {n_data} x {n_tile} mesh needs "
                         f"{n_data * n_tile} ranks, have {len(ranks)}")
    ranks = ranks[:n_data * n_tile]
    tiles, datas = mesh_ranks(n_data, n_tile, ranks)
    me = dist.get_rank()
    # new_group is collective over the default group: same calls, same
    # order, on every rank
    group = dist.new_group(ranks)
    tile_groups = [dist.new_group(r) for r in tiles]
    data_groups = [dist.new_group(r) for r in datas]
    if me not in ranks:
        return None
    pos = ranks.index(me)
    d, k = pos // n_tile, pos % n_tile
    return Mesh(n_data=n_data, n_tile=n_tile, ranks=ranks, rank=me,
                data_index=d, tile_index=k, group=group,
                tile_group=tile_groups[d], data_group=data_groups[k])
