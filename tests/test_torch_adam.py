"""The clip-and-Adam kernel's wrapper (``ops/adam.py``) on the CPU: the
leaf table cut into launches under the kernel-parameter limit, the
constants it shares with ``csrc/adam.cu``, which leaves the kernel takes
and how leaves on a card that it does not take are refused, the table's
reuse and its checks before any build, and the plain loop that CPU leaves
take."""

import re
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from twotowermlretrieval_tpu_torch.config import Config
from twotowermlretrieval_tpu_torch.ops import _build, adam
from twotowermlretrieval_tpu_torch.train.train_step import (
    apply_clip_and_adam,
    create_train_state,
)
from twotowermlretrieval_tpu_torch.utils.pytree import named_leaves

SOURCE = (Path(adam.__file__).resolve().parent.parent / "csrc" / "adam.cu").read_text()
PARAM_LIMIT = 32_764  # bytes of kernel parameters on sm_90 with CUDA 12.1 and later


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def test_constants_mirror_the_kernel_and_the_table_fits_a_launch():
    assert adam.TILE == _constant("TILE")
    assert adam.LEAVES_PER_LAUNCH == _constant("MAX_LEAVES")
    leaf = 4 * 8 + 8 + 2 * 4  # g, p, mu, nu; n; tile0, sq
    table = adam.LEAVES_PER_LAUNCH * leaf + 2 * 4
    update_args = 8 + 4 + 8 + 4 + 4 + 8  # sq, n_sq, count, max_norm, neg_lr, gnorm
    assert table + update_args <= PARAM_LIMIT


@pytest.mark.parametrize("leaves", [1, 36, 156, 639, 640, 641, 1281])
def test_launch_groups_cut_the_leaves_into_the_fewest_launches(leaves):
    sizes = [(7 * i) % 20_000 for i in range(leaves)]  # empty leaves among them
    groups = adam.launch_groups(sizes)
    assert len(groups) == -(-leaves // adam.LEAVES_PER_LAUNCH)
    assert [a for a, _, _ in groups] == list(range(0, leaves, adam.LEAVES_PER_LAUNCH))
    assert groups[-1][1] == leaves
    for a, b, tiles in groups:
        assert 0 < b - a <= adam.LEAVES_PER_LAUNCH
        assert tiles == sum(-(-n // adam.TILE) for n in sizes[a:b])


def test_launch_groups_count_tiles_of_a_large_leaf():
    # a 400,000 x 100 table: 4,883 tiles, the last one short
    assert adam.launch_groups([40_000_000, 1, 0, adam.TILE]) == [(0, 4, 4_883 + 1 + 0 + 1)]
    assert adam.launch_groups([5] * 3, per_launch=2) == [(0, 2, 2), (2, 3, 1)]


def _leaf(device="cuda:0", dtype=torch.float32, contiguous=True):
    return SimpleNamespace(device=torch.device(device), dtype=dtype,
                           is_contiguous=lambda: contiguous)


@pytest.mark.parametrize("other, takes", [
    (_leaf(), True),
    (_leaf(dtype=torch.bfloat16), False),
    (_leaf(dtype=torch.float16), False),
    (_leaf(contiguous=False), False),
    (_leaf(device="cuda:1"), False),
    (_leaf(device="cpu"), False),
])
def test_the_kernel_takes_f32_contiguous_leaves_on_one_card(other, takes):
    assert adam.kernel_takes([_leaf(), _leaf(), other]) is takes
    assert adam.kernel_takes([_leaf(device="cpu")]) is False
    assert adam.kernel_takes([]) is False


def _meta_leaves(shapes):
    return [torch.zeros(s, device="meta") for s in shapes]


def test_a_table_is_reused_for_the_same_leaves_and_remade_for_others(monkeypatch):
    monkeypatch.setattr(adam, "kernel_takes", lambda leaves: True)
    shapes = [(3,), (1023,), (400, 100), ()]
    params, mus, nus = (_meta_leaves(shapes) for _ in range(3))
    table = adam.table_for(params, mus, nus)
    assert isinstance(table, adam.LeafTable)
    assert table.numels == [3, 1023, 40_000, 1] and list(table.sizes) == table.numels
    assert table.groups == [(0, 4, 1 + 1 + 5 + 1)] and table.part_len == 8
    assert adam.table_for(params, mus, nus, table) is table
    nus[2] = torch.zeros((400, 100), device="meta")  # a moment replaced, not updated in place
    again = adam.table_for(params, mus, nus, table)
    assert again is not table and again.holds(params, mus, nus)
    with pytest.raises(ValueError, match="shape"):
        adam.LeafTable(params, mus, _meta_leaves([(3,), (1023,), (100, 400), (1,)]))


def test_bad_gradients_raise_before_any_build(monkeypatch):
    monkeypatch.setattr(adam, "kernel_takes", lambda leaves: True)

    def no_build(*a, **k):
        raise AssertionError("built")

    monkeypatch.setattr(_build, "load", no_build)
    params, mus, nus = (_meta_leaves([(3,), (5, 2)]) for _ in range(3))
    table = adam.LeafTable(params, mus, nus)
    count = torch.zeros((), dtype=torch.int32, device="meta")
    for grads in ([torch.zeros(3, device="meta")],  # too few
                  [torch.zeros(3, device="meta"), torch.zeros(9, device="meta")],
                  [torch.zeros(3, device="meta"),
                   torch.zeros((5, 2), dtype=torch.bfloat16, device="meta")],
                  [torch.zeros(3), torch.zeros((5, 2))]):  # on another device
        with pytest.raises(ValueError):
            adam.clip_and_adam(table, grads, count, 1.0, 1e-3)
    with pytest.raises(ValueError, match="int32"):
        adam.clip_and_adam(table, _meta_leaves([(3,), (5, 2)]), count.float(), 1.0, 1e-3)
    ptrs, copies = table.grad_pointers([torch.zeros(3, device="meta"),
                                        torch.zeros((2, 5), device="meta").T])
    assert len(ptrs) == 2 and len(copies) == 1 and copies[0].is_contiguous()


@pytest.mark.parametrize("other, what", [
    (_leaf(dtype=torch.bfloat16), "mu t/b is torch.bfloat16 on cuda:0"),
    (_leaf(dtype=torch.float16), "mu t/b is torch.float16 on cuda:0"),
    (_leaf(contiguous=False), "mu t/b is torch.float32, not contiguous, on cuda:0"),
    (_leaf(device="cuda:1"), "mu t/b is torch.float32 on cuda:1"),
    (_leaf(device="cpu"), "mu t/b is torch.float32 on cpu"),
])
def test_leaves_on_a_card_the_kernel_does_not_take_are_refused_by_name(other, what):
    """No plain loop on a card: a leaf the kernel does not take raises,
    naming its tree and path, before anything is built or launched."""
    params, nus = [_leaf(), _leaf()], [_leaf(), _leaf()]
    with pytest.raises(ValueError, match=re.escape(what)):
        adam.table_for(params, [_leaf(), other], nus, names=["t/a", "t/b"])
    with pytest.raises(ValueError, match=re.escape("param #1 is torch.bfloat16")):
        adam.LeafTable([_leaf(), _leaf(dtype=torch.bfloat16)], [_leaf()] * 2, [_leaf()] * 2)
    with pytest.raises(ValueError, match="2 params, 1 mu and 2 nu leaves"):
        adam.LeafTable(params, [_leaf()], nus)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_and_non_f32_leaves_take_the_loop_and_count_it(dtype):
    """CPU leaves, f32 or not, take the plain loop: no table, and the
    kernel's launch count does not move."""
    gen = torch.Generator().manual_seed(0)
    params = {"t": {"w": torch.randn((4, 6), generator=gen).to(dtype),
                    "b": torch.randn((6,), generator=gen).to(dtype)}}
    cfg = Config(lr=1e-2, freeze_embeddings=False)
    state = create_train_state(torch.Generator(), params, cfg)
    launches = adam.clip_and_adam.launches
    before = {n: p.detach().clone() for n, p in named_leaves(state.trainable)}
    for _ in range(2):
        grads = [torch.randn(p.shape, generator=gen).to(dtype)
                 for _, p in named_leaves(state.trainable)]
        gnorm = apply_clip_and_adam(state, grads, cfg)
        assert gnorm.dim() == 0 and bool(torch.isfinite(gnorm))
    assert state.leaf_table is None
    assert adam.clip_and_adam.launches == launches
    assert int(state.opt_state["count"]) == 2
    for n, p in named_leaves(state.trainable):
        assert not torch.equal(p, before[n]), n
