"""Gradient clip by global norm, then Adam, over every trainable leaf in a
few launches: the CUDA kernel's wrapper.

Replaces no TPU kernel: XLA fuses the JAX package's optax update. The
port's plain version is the loop of PyTorch operations in
``train/train_step.py`` ``apply_clip_and_adam`` (about 18 launches a leaf
on a card, and its bias corrections once built from host scalars). It is
what CPU leaves take, and what the tier-1 tests hold against optax.

:func:`clip_and_adam` launches ``csrc/adam.cu`` instead: every leaf's
square sum into an f32 [L] buffer, then (after an optional sum of the
model-sharded leaves' entries over their group) one update of every leaf,
which reads the norm's terms and the int32 step count from device memory
and computes the loop's arithmetic in the loop's order. The leaf table is a
kernel parameter: :class:`LeafTable` caches the addresses of the params and
moments (updated in place) once, and each step gathers only the gradients'.
Nothing is read back to the host and nothing is copied to the card, so the
update never synchronizes. A launch takes at most
:data:`LEAVES_PER_LAUNCH` leaves (:func:`launch_groups`).

The kernel takes a state's leaves where all are f32, contiguous and on one
CUDA device (:func:`kernel_takes`). :func:`table_for` gives ``None`` for
leaves on the CPU, where the caller runs the loop, and refuses leaves on a
card that the kernel does not take: the loop is never run on a card.
"""

from __future__ import annotations

import ctypes
import operator
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from twotowermlretrieval_tpu_torch.ops import _build

TILE = 8192  # elements of a leaf a CTA takes at a time: TILE in csrc/adam.cu
LEAVES_PER_LAUNCH = 640  # MAX_LEAVES in csrc/adam.cu: the table a kernel parameter holds

_VOIDP = ctypes.c_void_p
_INT = ctypes.c_int


def _lib():
    lib = _build.load("adam")
    if not getattr(lib, "_ttr_bound", False):
        lib.adam_squares_launch.restype = _INT
        # device, leaves, g, n, sq0, part, part_len, sq, done, stream
        lib.adam_squares_launch.argtypes = [_INT, _INT, _VOIDP, _VOIDP, _INT, _VOIDP,
                                            ctypes.c_longlong, _VOIDP, _VOIDP, _VOIDP]
        lib.adam_update_launch.restype = _INT
        # device, leaves, g, p, mu, nu, n, sq, n_sq, count, max_norm, neg_lr, gnorm, stream
        lib.adam_update_launch.argtypes = [_INT, _INT] + [_VOIDP] * 6 + [
            _INT, _VOIDP, ctypes.c_float, ctypes.c_float, _VOIDP, _VOIDP]
        lib.adam_error_string.restype = ctypes.c_char_p
        lib.adam_error_string.argtypes = [_INT]
        lib._ttr_bound = True
    return lib


def kernel_takes(leaves: Sequence[torch.Tensor]) -> bool:
    """Whether the kernel updates these leaves (params and moments): every
    one f32, contiguous and on the first one's CUDA device."""
    if not leaves or leaves[0].device.type != "cuda":
        return False
    dev = leaves[0].device
    return all(t.dtype == torch.float32 and t.device == dev and t.is_contiguous()
               for t in leaves)


def _refusal(params, mus, nus, names: Optional[Sequence[str]]) -> str:
    """What the kernel does not take, naming the first such leaf."""
    if not params or not (len(params) == len(mus) == len(nus)):
        return f"{len(params)} params, {len(mus)} mu and {len(nus)} nu leaves"
    dev = params[0].device
    for tree, leaves in (("param", params), ("mu", mus), ("nu", nus)):
        for i, t in enumerate(leaves):
            if not kernel_takes([params[0], t]):
                name = names[i] if names is not None else f"#{i}"
                return (f"the clip-and-Adam kernel takes f32 contiguous leaves on one CUDA device: "
                        f"{tree} {name} is {t.dtype}"
                        f"{'' if t.is_contiguous() else ', not contiguous,'} on {t.device} "
                        f"(the first param on {dev})")
    return "every leaf is taken"


def launch_groups(sizes: Sequence[int], per_launch: int = LEAVES_PER_LAUNCH
                  ) -> List[Tuple[int, int, int]]:
    """(first leaf, end, tiles) of each launch: the leaves in order, cut
    into as few launches as hold at most ``per_launch`` each; ``tiles`` is
    the launch's tiles of :data:`TILE` elements (a leaf's last tile may be
    short, an empty leaf has none)."""
    return [(a, min(a + per_launch, len(sizes)),
             sum(-(-int(n) // TILE) for n in sizes[a : a + per_launch]))
            for a in range(0, len(sizes), per_launch)]


def _pointers(ts) -> ctypes.Array:
    return (_VOIDP * len(ts))(*[t.data_ptr() for t in ts])


class LeafTable:
    """The kernel's view of one state's leaves: their sizes, the cached
    addresses of the params and moments (which it keeps alive), the launch
    groups and the device buffers the two passes share."""

    def __init__(self, params: Sequence[torch.Tensor], mus: Sequence[torch.Tensor],
                 nus: Sequence[torch.Tensor], names: Optional[Sequence[str]] = None):
        if not (len(params) == len(mus) == len(nus)) or not kernel_takes([*params, *mus, *nus]):
            raise ValueError(_refusal(params, mus, nus, names))
        for p, m, v in zip(params, mus, nus):
            if m.shape != p.shape or v.shape != p.shape:
                raise ValueError(f"a moment's shape differs from its leaf's: {tuple(p.shape)}")
        self.leaves = (tuple(params), tuple(mus), tuple(nus))
        self.device = params[0].device
        self.numels = [p.numel() for p in params]
        self.groups = launch_groups(self.numels)
        self.sizes = (ctypes.c_longlong * len(params))(*self.numels)
        self.p, self.mu, self.nu = _pointers(params), _pointers(mus), _pointers(nus)
        dev = self.device
        self.sq = torch.empty(len(params), dtype=torch.float32, device=dev)
        self.part_len = max(1, max(tiles for _, _, tiles in self.groups))
        self.part = torch.empty(self.part_len, dtype=torch.float32, device=dev)
        self.done = torch.zeros(1, dtype=torch.int32, device=dev)  # the last CTA's counter
        self._shards = {}

    def holds(self, params, mus, nus) -> bool:
        """Whether the table is these leaves (the same tensor objects)."""
        return all(len(a) == len(b) and all(map(operator.is_, a, b))
                   for a, b in zip(self.leaves, (params, mus, nus)))

    def grad_pointers(self, grads: Sequence[torch.Tensor]
                      ) -> Tuple[ctypes.Array, List[torch.Tensor]]:
        """The gradients' addresses, each checked against its leaf, and the
        contiguous copies of those that are not, which the caller holds
        until the kernels are queued (the allocator may then reuse them:
        only work queued behind the kernels touches them)."""
        if len(grads) != len(self.numels):
            raise ValueError(f"{len(grads)} gradients for {len(self.numels)} leaves")
        ptrs, copies = [], []
        for g, n in zip(grads, self.numels):
            if g.dtype != torch.float32 or g.device != self.device or g.numel() != n:
                raise ValueError(f"a gradient {g.dtype} {tuple(g.shape)} on {g.device} for an "
                                 f"f32 leaf of {n} elements on {self.device}")
            if not g.is_contiguous():
                g = g.contiguous()
                copies.append(g)
            ptrs.append(g.data_ptr())
        return (_VOIDP * len(ptrs))(*ptrs), copies

    def shard_index(self, sharded: Sequence[bool]) -> torch.Tensor:
        """The device index of the sharded leaves' entries (made once: its
        copy to the card waits for the card)."""
        key = tuple(bool(s) for s in sharded)
        if key not in self._shards:
            self._shards[key] = torch.tensor([i for i, s in enumerate(key) if s],
                                             dtype=torch.long, device=self.device)
        return self._shards[key]


def _at(arr: ctypes.Array, i: int) -> int:
    """The address of element ``i`` of a ctypes array."""
    return ctypes.addressof(arr) + i * ctypes.sizeof(arr._type_)


def _check(lib, err: int, fn: str) -> None:
    if err:
        raise RuntimeError(f"{fn} failed: {lib.adam_error_string(err).decode()}")


def table_for(params, mus, nus, cached: Optional[LeafTable] = None,
              names: Optional[Sequence[str]] = None) -> Optional[LeafTable]:
    """``cached`` where it holds these leaves; ``None`` where every leaf is
    on the CPU (the caller runs the plain loop); else a new table. Raises
    ``ValueError``, naming the leaf (``names``: the params' names), where a
    leaf is on a card but not f32, not contiguous or on another device."""
    if cached is not None and cached.holds(params, mus, nus):
        return cached
    if all(t.device.type == "cpu" for t in (*params, *mus, *nus)):
        return None
    return LeafTable(params, mus, nus, names)


@torch.no_grad()
def clip_and_adam(table: LeafTable, grads: Sequence[torch.Tensor], count: torch.Tensor,
                  max_norm: float, lr: float, sharded: Optional[Sequence[bool]] = None,
                  group_sum: Optional[Callable[[torch.Tensor], object]] = None) -> torch.Tensor:
    """clip_by_global_norm(max_norm) then Adam(lr) in place on the table's
    leaves, from ``grads`` in the table's order; ``count``: the int32 step
    count on the card, already advanced to this step. Returns the global
    norm of ``grads`` before the clip, a 0-d f32 tensor on the card. With
    ``sharded`` (a flag a leaf), ``group_sum`` sums a tensor in place over
    the model group: the sharded leaves' square sums go through it, a
    replicated leaf's counts once."""
    if count.dtype != torch.int32 or count.device != table.device:
        raise ValueError(f"the step count must be an int32 scalar on {table.device}")
    g, copies = table.grad_pointers(grads)  # copies: held here until the kernels are queued
    lib = _lib()
    dev = table.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    L = len(table.numels)
    for a, b, _ in table.groups:
        _check(lib, lib.adam_squares_launch(dev.index, b - a, _at(g, a), _at(table.sizes, a), a,
                                            table.part.data_ptr(), table.part_len,
                                            table.sq.data_ptr(), table.done.data_ptr(), stream),
               "adam_squares_launch")
    if sharded is not None and any(sharded):
        idx = table.shard_index(sharded)
        summed = table.sq.index_select(0, idx)
        group_sum(summed)
        table.sq.index_copy_(0, idx, summed)
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    for a, b, _ in table.groups:
        _check(lib, lib.adam_update_launch(dev.index, b - a, _at(g, a), _at(table.p, a),
                                           _at(table.mu, a), _at(table.nu, a),
                                           _at(table.sizes, a), table.sq.data_ptr(), L,
                                           count.data_ptr(), float(max_norm), -float(lr),
                                           gnorm.data_ptr(), stream),
               "adam_update_launch")
    clip_and_adam.launches += 2 * len(table.groups)
    return gnorm


clip_and_adam.launches = 0  # kernel launches, counted where the kernels are launched
