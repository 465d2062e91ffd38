"""The port's dropout: the plain version of the B3 kernel held to the
reference's contract, and the port's dropout units against the
reference's.

The reference's mask bits come from the TPU core (its Pallas kernel) or
from ``jax.random`` (its XLA path), which no other machine reproduces,
so only the contract is owed: keep each element with probability
1 − ratio, scale the kept ones by 1/(1 − ratio), regenerate the same
mask in the backward, and be the identity at ratio 0 and in eval mode.
The keep fraction is held within 4σ of 1 − ratio.  At ratio 0 the units
are compared with the reference's exactly.
"""

import numpy as np
import pytest
import torch

from znicz_tpu.backends import XLADevice
from znicz_tpu.dummy import DummyUnit, DummyWorkflow
from znicz_tpu.memory import Vector
from znicz_tpu.ops import dropout as ref_dropout
from znicz_tpu.utils.config import root as ref_root
from znicz_tpu_torch.ops import fused_kernels as fk
from znicz_tpu_torch.ops.dropout import DropoutBackward, DropoutForward
from znicz_tpu_torch.utils import prng


@pytest.mark.parametrize("ratio", [0.5, 0.1, 0.9])
def test_keep_fraction_and_scale(ratio):
    n = 32 * 4096  # rows of the AlexNet fc activations
    x = torch.ones(32, 4096)
    y = fk.dropout_apply_plain(x, seed=20261016, drop_ratio=ratio)
    kept = y != 0
    frac = float(kept.float().mean())
    sigma = (ratio * (1 - ratio) / n) ** 0.5
    assert abs(frac - (1 - ratio)) <= 4 * sigma
    assert torch.all(y[kept] == torch.tensor(1.0 / (1.0 - ratio)))
    # the bits are uniform on 32 bits: a coarse look at every byte
    bits = fk.dropout_bits(n, 20261016)
    for shift in (0, 8, 16, 24):
        counts = torch.bincount((bits >> shift) & 0xFF, minlength=256)
        expect = n / 256
        assert float((counts - expect).abs().max()) < 5 * expect ** 0.5


def test_mask_is_a_function_of_the_seed_and_the_index():
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 1, (64, 96)).astype(np.float32)).to(torch.bfloat16)
    a = fk.dropout_apply_plain(x, 7, 0.5)
    b = fk.dropout_apply_plain(x, 7, 0.5)
    c = fk.dropout_apply_plain(x, 8, 0.5)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.dtype == torch.bfloat16
    # the backward's mask is the forward's: the same seed on the error
    err = torch.from_numpy(np.random.default_rng(2).normal(
        0, 1, x.shape).astype(np.float32)).to(torch.bfloat16)
    back = fk.dropout_apply_plain(err, 7, 0.5)
    assert torch.equal(a != 0, back != 0)
    np.testing.assert_array_equal(back.float().numpy(),
                                  (err.float() * (a != 0) * 2.0).to(
                                      torch.bfloat16).float().numpy())
    # the threshold is the TPU kernel's: bits > ratio·(2³²−1)
    bits = fk.dropout_bits(x.numel(), 7).reshape(x.shape)
    assert torch.equal(a != 0, (bits > int(0.5 * (2 ** 32 - 1)))
                       & (x != 0))


def test_ratio_zero_is_the_identity():
    x = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, (300, 70)).astype(np.float32))
    for seed in (0, 1, 2 ** 63 - 1):
        assert torch.equal(fk.dropout_apply_plain(x, seed, 0.0), x)
    with pytest.raises(ValueError, match="not in"):
        fk.dropout_apply_plain(x, 0, 1.0)


def test_wrapper_takes_the_plain_version_for_cpu_tensors_only():
    x = torch.ones(4, 33)
    before = fk.dropout_apply.launches
    assert torch.equal(fk.dropout_apply(x, 5, 0.5),
                       fk.dropout_apply_plain(x, 5, 0.5))
    assert fk.dropout_apply.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        fk.dropout_apply(x.to("meta"), 5, 0.5)


def _ref_dropout(x, err, dtype, mode):
    ref_root.common.precision_type = dtype
    wf = DummyWorkflow()
    src = DummyUnit(wf, output=Vector(x.copy(), name="x"))
    fwd = ref_dropout.DropoutForward(wf, dropout_ratio=0.0)
    fwd.link_attrs(src, ("input", "output"))
    fwd.initialize(device=XLADevice())
    fwd.forward_mode = mode
    err_src = DummyUnit(wf, err=Vector(err.copy(), name="err"))
    bwd = ref_dropout.DropoutBackward(wf)
    bwd.forward_unit = fwd
    bwd.link_attrs(fwd, "input", "output")
    bwd.link_attrs(err_src, ("err_output", "err"))
    bwd.initialize(device=XLADevice())
    fwd.run()
    bwd.run()
    fwd.output.map_read()
    bwd.err_input.map_read()
    return (np.asarray(fwd.output.mem).astype(np.float32),
            np.asarray(bwd.err_input.mem).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "eval"])
def test_units_at_ratio_zero_match_the_reference(dtype, mode):
    tdt = getattr(torch, dtype)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (6, 40)).astype(
        np.float32)).to(tdt)
    err = torch.from_numpy(rng.normal(0, 1, x.shape).astype(
        np.float32)).to(tdt)
    want_y, want_dx = _ref_dropout(x.float().numpy(), err.float().numpy(),
                                   dtype, mode)
    unit = DropoutForward((40,), tdt, dropout_ratio=0.0)
    unit.forward_mode = mode
    gd = DropoutBackward(unit, need_err_input=True)
    y = unit(x)
    dx = gd.run(x, err, y)
    assert (unit.seed is None) == (mode == "eval")
    assert y.dtype == dx.dtype == tdt
    np.testing.assert_array_equal(y.float().numpy(), want_y)
    np.testing.assert_array_equal(dx.float().numpy(), want_dx)


def test_unit_draws_one_seed_a_train_step_from_the_port_generator():
    prng.seed_all(11)
    unit = DropoutForward((4096,), torch.bfloat16)
    gd = DropoutBackward(unit, need_err_input=True)
    x = torch.ones(8, 4096, dtype=torch.bfloat16)
    y = unit(x)
    seed = unit.seed
    prng.seed_all(11)
    assert seed == int(prng.get().randint(0, 2 ** 63))
    assert torch.equal(y, fk.dropout_apply_plain(x, seed, 0.5))
    dx = gd.run(x, torch.ones_like(x), y)
    assert torch.equal(dx, y)  # the same mask, and the same scale
    y2 = unit(x)
    assert unit.seed != seed and not torch.equal(y2, y)


def test_route_rule():
    """Which kernel a call takes on the card (:func:`fk.dropout_route`):
    the vector kernel when every operand lies on a 16-byte boundary, in
    either dtype and at any size (its last short run element by
    element), the general kernel for a view off 16 bytes."""
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.empty(128, 4096, dtype=dtype)
        assert fk.dropout_route(x.data_ptr(), torch.empty_like(
            x).data_ptr()) == "vector"
        flat = torch.empty(1001, dtype=dtype)
        per16 = 16 // flat.element_size()
        assert fk.dropout_route(flat[1:].data_ptr()) == "general"
        assert fk.dropout_route(flat[per16:].data_ptr()) == "vector"


#: the vector kernel of csrc/dropout.cu: elements a thread owns at once,
#: threads a block, and a resident wave of blocks on an H100 (8 blocks of
#: 256 threads on each of 132 SMs)
RUN, THREADS, RESIDENT = 8, 256, 8 * 132
M32 = 0xFFFFFFFF


def _philox_word0(c0, c1, seed):
    """Word 0 of Philox4x32-10 at counters (c0, c1, 0, 0), key (seed mod
    2³², seed div 2³²), on int64 tensors of 32-bit words: the rounds as
    ``philox_bits8`` takes them, each product of a 32-bit constant and a
    32-bit word as one 64-bit product (exact in int64 through its 16-bit
    halves) split into its high and low words."""
    def wide(m, c):
        lo = (m & 0xFFFF) * c
        hi = (m >> 16) * c
        full_lo = lo + ((hi & 0xFFFF) << 16)
        return ((hi >> 16) + (full_lo >> 32)) & M32, full_lo & M32

    c2, c3 = torch.zeros_like(c0), torch.zeros_like(c0)
    k0, k1 = seed & M32, (seed >> 32) & M32
    for _ in range(10):
        hi0, lo0 = wide(0xD2511F53, c0)
        hi1, lo1 = wide(0xCD9E8D57, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + 0x9E3779B9) & M32, (k1 + 0xBB67AE85) & M32
    return c0


def _vector_kernel_bits(n, seed, start_run=0):
    """The vector kernel's bits for elements ``8·start_run`` on, in its
    order of work: a grid of min(⌈runs / 256⌉, RESIDENT) blocks, thread t
    taking the runs t, t + grid, ... of 8 elements; a run's 8 counters
    share the high word of its first index and take low words lo .. lo
    + 7; in the last, short run only the elements below n are written.
    Returns the words of elements 8·start_run .. n − 1 (−1 where no
    thread wrote) and how often each run was taken."""
    runs = -(-n // RUN)
    grid = min(-(-(runs - start_run) // THREADS), RESIDENT) * THREADS
    out = torch.full((n - RUN * start_run,), -1, dtype=torch.int64)
    taken = torch.zeros(runs - start_run, dtype=torch.int64)
    for first in range(start_run, runs, grid):
        run = torch.arange(first, min(first + grid, runs))
        taken[run - start_run] += 1
        i0 = run * RUN
        lo, hi = i0 & M32, i0 >> 32
        assert int((lo + RUN - 1).max()) <= M32  # no run crosses 2³²
        for j in range(RUN):
            bits = _philox_word0(lo + j, hi, seed)
            at = i0 + j
            inside = at < n
            out[at[inside] - RUN * start_run] = bits[inside]
    return out, taken


@pytest.mark.parametrize("n", [1, 7, 8, 9, 4_000_037])
def test_vector_kernel_order_gives_the_plain_bits(n):
    """The vector kernel's index mapping with its tail, emulated on the
    CPU (:func:`_vector_kernel_bits`), writes every element once, with
    exactly the bits of :func:`fk.dropout_bits`, the plain version's
    mask.  4,000,037 elements (chip_smoke's ``long_ragged``) need more
    than one resident wave, so threads take a second run."""
    seed = 0x1234_5678_9ABC_DEF0
    bits, taken = _vector_kernel_bits(n, seed)
    assert bool((taken == 1).all())
    assert torch.equal(bits, fk.dropout_bits(n, seed))


def test_vector_kernel_runs_across_the_high_counter_word():
    """Runs of 8 just below and above element 2³², where the counter's
    high word changes: an 8-aligned run never crosses it, so a run's 8
    counters share one high word and the bits stay the plain ones."""
    seed = 20261016
    start_run = (2 ** 32 - 64) // RUN
    n = 2 ** 32 + 61
    bits, taken = _vector_kernel_bits(n, seed, start_run)
    assert bool((taken == 1).all())
    assert torch.equal(bits, fk.dropout_bits(n - RUN * start_run, seed,
                                             start=RUN * start_run))
