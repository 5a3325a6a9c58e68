"""The plain reference against hand-worked renders, and its two replays
against each other."""

import numpy as np
import pytest
import torch

from reference import threefry
from reference import uniform_f32 as ref

# 4x4 canvas over [-2, 2]^2: one pixel a unit square.
SCENE = ref.Scene(width=4, height=4, min_real=-2.0, max_real=2.0,
                  min_imag=-2.0, max_imag=2.0, min_it=2, max_it=10)


def test_threefry_known_answer():
    # Random123's known-answer vector of Threefry-2x32, 20 rounds.
    assert threefry.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                                 0x85A308D3) == (0xC4923A9C, 0x483DF7A0)
    assert threefry.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)


def test_key_derivation():
    assert threefry.fold_in(threefry.key(0), 0) == (0x6B200159, 0x99BA4EFE)
    assert threefry.key(2 ** 32 + 5) == (1, 5)
    assert threefry.bits((0, 0), 3, "cpu").tolist() == threefry.bits_host(
        (0, 0), 3)


def test_replay_of_c_one_half_by_hand():
    # z1 = 0.75, z2 = 1.0625, z3 = 1.62890625, z4 = 3.15...: escape index
    # 3 records z1..z4; the first three lie in row 2, columns 2, 3, 3.
    want = torch.zeros(16, dtype=torch.int64)
    want[2 * 4 + 2], want[2 * 4 + 3] = 1, 2
    for hist, hits in (
        ref.replay_numpy(np.array([0.5]), np.zeros(1), np.array([3]), SCENE),
        ref.replay_torch(torch.tensor([0.5]), torch.zeros(1),
                         torch.tensor([3]), SCENE),
    ):
        assert torch.equal(hist.to(torch.int64), want)
        assert hits == 3


def test_classify_of_c_one_half_by_hand():
    # Every lane holds c = 0.5 at z = c: windows of one step reach it = 3
    # and escape in the fourth, so each lane records (0.5, 0, 3) and draws.
    n = 128
    lanes = ref.init_lanes(n, "cpu")
    lanes.update(cr=torch.full((n,), 0.5), zr=torch.full((n,), 0.5),
                 dead=torch.zeros(n, dtype=torch.int32))
    plan = ref.Plan(lanes=n, steps_per_pass=4, steps_per_flush=4, unroll=1,
                    capacity=n)
    after, (e_r, e_i, e_it), counts = ref.classify(lanes, 1, 2, plan, SCENE)
    assert e_it.tolist() == [[3] * n]
    assert e_r.tolist() == [[0.5] * n] and e_i.tolist() == [[0.0] * n]
    assert counts["in_band"] == n and counts["samples"] == n
    assert counts["wasted"] == 0 and counts["iters"] == 4 * n
    assert int(after["it"].sum()) == 0
    # The lanes drew window 3's samples: Threefry at (lane, 3).
    w_r, _ = threefry.threefry2x32(1, 2, torch.arange(n),
                                   torch.full((n,), 3))
    want = ((w_r >> 8).to(torch.int32).to(torch.float32) * 2.0 ** -24
            * 4.0 - 2.0)
    assert torch.equal(after["cr"], want)


def test_select_keeps_all_that_fit_and_draws_the_rest():
    it = torch.tensor([[3, -1, 5, 7], [-1, 2, 9, 4]], dtype=torch.int32)
    c = torch.arange(8, dtype=torch.float32).reshape(2, 4)

    def plan(cap):
        return ref.Plan(lanes=4, steps_per_pass=8, steps_per_flush=4,
                        unroll=1, capacity=cap)

    (_, _, kept_it), counts = ref.select((c, c, it), (1, 2), plan(8), 10)
    assert counts == (6, 0)
    assert sorted(kept_it.tolist()) == [2, 3, 4, 5, 7, 9]
    (cr, _, kept_it), counts = ref.select((c, c, it), (1, 2), plan(3), 10)
    assert counts == (3, 3) and (kept_it >= 0).all()
    # The three with the smallest 11-bit keys (slots and cap are small).
    words = threefry.bits(threefry.fold_in((1, 2), ref.SELECT_FOLD), 8,
                          "cpu")
    keys = sorted((min(int(w) >> 21, 2046), s) for s, w in enumerate(words)
                  if it.reshape(-1)[s] >= 0)
    assert sorted(int(x) for x in cr) == sorted(s for _, s in keys[:3])


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_numpy_and_torch_replays_agree(seed):
    g = torch.Generator().manual_seed(seed % 1000)
    cr = torch.rand(300, generator=g) * 3 - 2
    ci = torch.rand(300, generator=g) * 3 - 1.5
    it = torch.randint(0, 60, (300,), generator=g, dtype=torch.int32)
    scene = ref.Scene(width=37, height=29, min_real=-2.0, max_real=1.0,
                      min_imag=-1.2, max_imag=1.3, min_it=1, max_it=60)
    h_np, n_np = ref.replay_numpy(cr.numpy(), ci.numpy(), it.numpy(), scene)
    h_t, n_t = ref.replay_torch(cr, ci, it, scene)
    assert n_np == n_t > 0
    assert torch.equal(h_np.to(torch.int64), h_t)


def test_run_pass_draws_the_ordinals_own_stream():
    scene = ref.Scene(width=40, height=30, min_real=-2.0, max_real=2.0,
                      min_imag=-1.5, max_imag=1.5, min_it=20, max_it=100)
    plan = ref.Plan(lanes=256, steps_per_pass=64, steps_per_flush=32,
                    unroll=1, capacity=4096)
    lanes = ref.init_lanes(plan.lanes, "cpu")
    a0, h0, c0 = ref.run_pass(lanes, 2 ** 31 + 5, 3, plan, scene)
    a0b, _, _ = ref.run_pass(lanes, 2 ** 31 + 5, 3, plan, scene, ordinal=0)
    a1, h1, c1 = ref.run_pass(lanes, 2 ** 31 + 5, 3, plan, scene, ordinal=1)
    assert all(torch.equal(a0[k], a0b[k]) for k in a0)
    assert not torch.equal(a0["cr"], a1["cr"])
    assert not torch.equal(h0, h1) and c0 != c1
