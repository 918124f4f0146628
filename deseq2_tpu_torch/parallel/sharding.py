"""The gene mesh: the genes axis split over several devices (the JAX
package's deseq2_tpu/parallel/sharding.py).

PyTorch has no shard_map, so the port's mesh is single-controller, as the
JAX package's is: one process holds a GeneMesh, an ordered list of
devices, and the genes axis is cut into one contiguous row block per
entry, blocks of ceil(G/n) rows with the last ones shorter (the JAX
package's layout, with no padding rows: a block may be short or empty).
The per-gene chains run one block at a time, each on its own device; the
cross-gene reductions (size factors, trend, MAD, prior variances, BH, the
filtering quantiles) run once, on the blocks' outputs gathered onto the
mesh's first device, with the single-device code, so they equal the
single-device run.  Every gather goes through GeneMesh.gather.

Multi-process mode: with a torch.distributed process group each rank holds
a GeneMesh of its own local devices, and the mesh is the ranks' devices in
rank order; each rank runs only its own row blocks and gather is an
all_gather of the blocks' outputs, padded to equal rows for the collective
and stripped after, so that every rank then runs the reductions on the
same full vectors.  gloo collects through host memory (the CPU, or two
ranks sharing one card, which NCCL refuses), NCCL between cards.

A mesh may list one device more than once (the tests' meshes of CPU
shards, the smoke run's shards on one card): a testing aid, which splits
the work without adding a device.
"""

from __future__ import annotations

import torch

__all__ = ["GeneMesh", "gene_mesh", "shard_genes", "replicated"]


class GeneMesh:
    """An ordered list of devices over the genes axis, and in
    multi-process mode the process group whose ranks hold the rest.

    `devices`: this process's devices (every shard's in single-process
    mode); `size`: the number of shards over all ranks."""

    def __init__(self, devices, process_group=None):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a gene mesh needs at least one device")
        self.group = process_group
        if process_group is None:
            self.rank, self.world = 0, 1
        else:
            import torch.distributed as dist
            self.rank = dist.get_rank(process_group)
            self.world = dist.get_world_size(process_group)
        self.size = self.world * len(self.devices)

    def __repr__(self):
        where = "" if self.group is None else \
            f", rank {self.rank} of {self.world}"
        return f"GeneMesh({[str(d) for d in self.devices]}{where})"

    @property
    def first_device(self):
        """Where this process runs the cross-gene reductions."""
        return self.devices[0]

    def bounds(self, G):
        """Every shard's (lo, hi) rows: blocks of ceil(G/size)."""
        b = -(-G // self.size)
        return [(min(k * b, G), min((k + 1) * b, G))
                for k in range(self.size)]

    def shards(self, G):
        """(lo, hi, device) of this process's non-empty shards."""
        first = self.rank * len(self.devices)
        own = self.bounds(G)[first:first + len(self.devices)]
        return [(lo, hi, d) for (lo, hi), d in zip(own, self.devices)
                if hi > lo]

    def split(self, t, G=None):
        """This process's row blocks of the (G, ...) tensor `t`, each on its
        shard's device (a view where it already lies there); t = None
        gives one None per block of G genes."""
        if t is None:
            return [None] * len(self.shards(G))
        return [t[lo:hi].to(d) for lo, hi, d in self.shards(t.shape[0])]

    def gather(self, parts, G, device=None):
        """The full (G, ...) tensor from this process's blocks `parts` (in
        shards() order) on `device` (default the first device): a
        concatenation, or in multi-process mode an all_gather."""
        device = self.first_device if device is None else device
        if self.group is None:
            if len(parts) == 1:
                return parts[0].to(device)
            return torch.cat([p.to(device) for p in parts])
        return self._all_gather(parts, G, device)

    def _all_gather(self, parts, G, device):
        import torch.distributed as dist
        if not parts:
            raise ValueError(f"rank {self.rank} holds no genes of {G}: "
                             "use a mesh of fewer shards")
        n_local = len(self.devices)
        b = -(-G // self.size)
        rows = [min((r + 1) * n_local * b, G) - min(r * n_local * b, G)
                for r in range(self.world)]
        nccl = dist.get_backend(self.group) == "nccl"
        coll = self.first_device if nccl else torch.device("cpu")
        dtype = parts[0].dtype
        wire = torch.uint8 if dtype == torch.bool else dtype
        block = torch.cat([p.to(device=coll, dtype=wire) for p in parts])
        pad = block.new_zeros((n_local * b - block.shape[0],)
                              + tuple(block.shape[1:]))
        block = torch.cat([block, pad])
        got = [torch.empty_like(block) for _ in range(self.world)]
        dist.all_gather(got, block, group=self.group)
        full = torch.cat([g[:n] for g, n in zip(got, rows)])
        return full.to(device=device, dtype=dtype)


def gene_mesh(n_devices=None, devices=None, process_group=None):
    """A GeneMesh over `devices` (torch devices or their names), by default
    every visible card, the first `n_devices` of them.  With
    `process_group` (torch.distributed) `devices` are this rank's, by
    default the card numbered rank modulo the card count."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass devices= "
                               "(e.g. ['cpu'] * n) for a mesh of CPU shards")
        n_cards = torch.cuda.device_count()
        if process_group is not None:
            import torch.distributed as dist
            devices = [torch.device("cuda",
                                    dist.get_rank(process_group) % n_cards)]
        else:
            devices = [torch.device("cuda", i) for i in range(n_cards)]
            if n_devices is not None:
                devices = devices[:n_devices]
    return GeneMesh(devices, process_group)


def as_mesh(mesh):
    """`mesh` checked to be a GeneMesh (None passes through)."""
    if mesh is not None and not isinstance(mesh, GeneMesh):
        raise TypeError(f"mesh must be a GeneMesh (parallel.gene_mesh), not "
                        f"{type(mesh).__name__}")
    return mesh


def shard_genes(mesh, t):
    """The port's counterpart of the JAX package's genes-axis sharding:
    `t`'s row blocks on their shards' devices (GeneMesh.split)."""
    return mesh.split(t)


def replicated(mesh, t, G):
    """The counterpart of the replicated sharding: `t` on the device of
    each of this process's non-empty shards for G genes."""
    return [t.to(d) for _, _, d in mesh.shards(G)]
