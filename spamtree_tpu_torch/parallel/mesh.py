"""The chains x blocks device mesh over ``torch.distributed``.

Counterpart of ``make_mesh`` in ``spamtree_tpu/parallel/sharding.py``: one
rank per device, NCCL for CUDA devices and gloo for CPU devices, laid out
as an (n_chains, n_blocks) grid in rank order.  Rank r sits at chain row
r // n_blocks and blocks column r % n_blocks; ``dist.new_group`` gives each
row its blocks group and each column its chains group.

The collectives the sharded sampler needs are methods here, so the model
code reaches them through ``ModelStatic.mesh`` without importing this
module.  Each is one all-gather into a single output tensor, which gloo
and NCCL both implement; a sum over ranks adds the gathered parts in rank
order on every rank, so every rank holds the same bits and two runs of
one mesh agree.  On an NCCL mesh the collectives read no host value and
allocate their output from the caching allocator (a CUDA graph's pool
inside a capture), so ``mcmc.StepRunner`` captures them with the rest of
the iteration; a one-rank group gathers too, so its graphs hold the
collective as a larger mesh's do.  Under gloo, CUDA tensors cross through
host memory, which a capture cannot hold.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Mesh:
    """This rank's place in the chains x blocks grid, its axis groups and
    its device."""

    def __init__(self, n_chains: int, n_blocks: int, device, backend: str,
                 rank: int, chains_group, blocks_group):
        self.n_chains = n_chains
        self.n_blocks = n_blocks
        self.device = torch.device(device)
        self.backend = backend
        self.rank = rank
        self.chain_rank = rank // n_blocks
        self.block_rank = rank % n_blocks
        self.chains_group = chains_group
        self.blocks_group = blocks_group

    def _gather(self, x: torch.Tensor, group, size: int) -> torch.Tensor:
        """Every rank's ``x`` of ``group``, in rank order, as one (size,
        *x.shape) tensor on x's device."""
        src = x.detach()
        if src.dtype == torch.bool:
            src = src.to(torch.uint8)
        if self.backend == "gloo" and src.is_cuda:
            src = src.cpu()
        src = src.contiguous().reshape(-1)
        # flat on both sides: gloo wants the output's shape to be the
        # input's stacked along dim 0, NCCL its size alone
        out = src.new_empty(size * src.numel())
        _all_gather(out, src, group=group)
        return out.reshape(size, *x.shape).to(device=x.device, dtype=x.dtype)

    def cat_blocks(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The blocks ranks' shards of ``x`` joined along ``dim``."""
        return _join(self._gather(x, self.blocks_group, self.n_blocks), dim)

    def sum_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of ``x`` over the blocks ranks, added in rank order."""
        parts = self._gather(x, self.blocks_group, self.n_blocks)
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out

    def all_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """Logical AND of a bool ``x`` over the blocks ranks."""
        return self._gather(x, self.blocks_group, self.n_blocks).all(0)

    def cat_chains(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The chains ranks' chains of ``x`` joined along ``dim``."""
        return _join(self._gather(x, self.chains_group, self.n_chains), dim)

    def barrier(self) -> None:
        """Wait for every rank of the mesh."""
        self._gather(torch.zeros(1, device=self.device), None,
                     self.n_chains * self.n_blocks)


# newer torch versions name all_gather_into_tensor all_gather_single and
# deprecate the old name
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def _join(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """``torch.cat`` of the (size, ...) gathered parts along ``dim`` of a
    part: the rank axis moved next to ``dim`` and merged into it."""
    dim = dim % (parts.dim() - 1)
    joined = parts.movedim(0, dim)
    s = joined.shape
    return joined.reshape(*s[:dim], s[dim] * s[dim + 1], *s[dim + 2:])


def make_mesh(n_chains: int = 1, n_blocks_shards: int | None = None,
              device=None, timeout=None) -> Mesh:
    """The (n_chains, n_blocks_shards) mesh over the initialised default
    process group; every rank calls it with the same sizes.  ``device``
    defaults to the current CUDA device, whatever the backend, and raises
    where CUDA is absent: CPU ranks pass ``device="cpu"``.  ``timeout`` (a
    timedelta) bounds each collective of the axis groups (default:
    torch.distributed's for the backend)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "process group (init_process_group)")
    world = dist.get_world_size()
    rank = dist.get_rank()
    backend = dist.get_backend()
    if n_blocks_shards is None:
        n_blocks_shards = world // n_chains
    if n_chains < 1 or n_chains * n_blocks_shards != world:
        raise ValueError(f"{n_chains} x {n_blocks_shards} != {world} ranks")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "device='cpu' for CPU ranks")
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL mesh runs on CUDA devices, got {device}")
    # every rank creates every group, in the same order
    chains_group = blocks_group = None
    for c in range(n_chains):
        g = dist.new_group(list(range(c * n_blocks_shards,
                                      (c + 1) * n_blocks_shards)),
                           timeout=timeout)
        if rank // n_blocks_shards == c:
            blocks_group = g
    for b in range(n_blocks_shards):
        g = dist.new_group(list(range(b, world, n_blocks_shards)),
                           timeout=timeout)
        if rank % n_blocks_shards == b:
            chains_group = g
    return Mesh(n_chains, n_blocks_shards, device, backend, rank,
                chains_group, blocks_group)
