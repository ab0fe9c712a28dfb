"""The port's FPGA arithmetic (caiman_asr_tpu_torch/ops/quantize.py and the
quantized LSTM in ops/lstm.py) against the JAX package's
(caiman_asr_tpu/ops/quantize.py, ops/lstm.py), on the same inputs made with
numpy from a seed or drawn by hypothesis.

The quantizers must agree to the bit with JAX's (run op by op), boundary
values included: ±2^k, ±2^k·(1−2^-24) and subnormals. The quantized LSTM
runs inside JAX's jitted scan and step, where XLA's fused quantizer leaves
some values one fp32 ulp off the brain-float grid (``jax.jit`` of
``brain_float_quantize`` differs from its op-by-op run on 208 of 200,000
normal draws times 3, each by one ulp). So the LSTM must agree to the bit
or within 2^-20 of the magnitude (ULP_REL), and beyond that within one
brain-float step (2^-8 of the magnitude) on at most 0.1% of its entries;
each test prints its counts. Also mirrors tests/ops/test_quantize.py and
tests/ops/test_quantized_lstm.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from caiman_asr_tpu.decoding.greedy import GreedyDecoder as JaxGreedy
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu.ops import quantize as jq
from caiman_asr_tpu.ops.lstm import init_lstm
from caiman_asr_tpu.ops.lstm import lstm_step as jax_lstm_step
from caiman_asr_tpu.ops.lstm import run_lstm as jax_run_lstm
from caiman_asr_tpu.ops.lstm import run_lstm_layer as jax_run_lstm_layer
from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT
from caiman_asr_tpu_torch.ops import quantize as tq
from caiman_asr_tpu_torch.ops.lstm import lstm_step, run_lstm, run_lstm_layer

BF_STEP = 2.0 ** -8    # one brain-float step, relative to the magnitude
MAX_SHARE = 1e-3       # of the entries allowed one step apart
ULP_REL = 2.0 ** -20   # a few fp32 ulps: XLA's fused quantizer, off the grid
# The model's encoder (two quantized layers over 20 frames): JAX's off-grid
# values break exact brain-float ties (common: sums of products of 8-bit
# mantissas) the other way, and a flipped entry feeds every later frame
ENC_MAX_SHARE = 0.025


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a, np.float32)), tree)


def bits_equal(a, b) -> np.ndarray:
    """Elementwise: the same fp32 bits, or both NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return (a.view(np.uint32) == b.view(np.uint32)) | (np.isnan(a) & np.isnan(b))


def boundary_values() -> np.ndarray:
    ks = np.arange(-126, 128)
    pos = np.concatenate([np.ldexp(1.0, ks), np.ldexp(1.0 - 2.0 ** -24, ks)])
    sub = np.array([1e-45, 1e-40, 3e-39, 1.1754942e-38])
    v = np.concatenate([pos, sub]).astype(np.float32)
    return np.concatenate([v, -v, [0.0, -0.0]]).astype(np.float32)


def both(fn_name, x, *args, **kw):
    want = getattr(jq, fn_name)(jnp.asarray(x), *args, **kw)
    got = getattr(tq, fn_name)(torch.from_numpy(np.asarray(x, np.float32)), *args, **kw)
    return got, want


# ------------------------------------------------------------ quantizers
def test_brain_float_boundaries_bit_equal():
    got, want = both("brain_float_quantize", boundary_values())
    assert bits_equal(got.numpy(), want).all()


def test_frexp_boundaries_equal():
    """The exponents of _frexp, JAX's formula (not torch.frexp), where log2
    rounds near an integer: XLA's log differs from torch.log2 at 2^-30,
    2^13 and others, and the port follows XLA's."""
    x = boundary_values()
    (gm, ge), (wm, we) = both("_frexp", x)
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we))
    assert bits_equal(gm.numpy(), wm).all()
    # not torch.frexp: at 2^13 the scale lax.exp2(13) is not 8192, so the
    # mantissa stays just below 1 where frexp gives 0.5 (and at 2^-126 just
    # below 0.5)
    i = np.flatnonzero(x == np.float32(2.0 ** 13))[0]
    assert 0.9999 < float(gm[i]) < 1.0 and int(ge[i]) == 13
    assert float(gm[np.flatnonzero(x == np.float32(2.0 ** -126))[0]]) < 0.5


@pytest.mark.parametrize("man_bits", [4, 8])
def test_bfp_boundaries_bit_equal(man_bits):
    """Blocks of 8 whose largest entry is a boundary value: the shared
    exponent, and so every entry's grid, comes from _frexp."""
    x = boundary_values()
    blocks = np.stack([x, x / 3, x / 5, -x / 7, x / 11, x / 13, -x / 17, x / 19], 1)
    got, want = both("bfp_quantize", blocks.astype(np.float32), man_bits, -1, 8)
    assert bits_equal(got.numpy(), want).all()


def test_exp2_is_lax_exp2():
    """lax.exp2 is exp(x * log 2): not a power of two for integers past
    about 12 (2^13 = 8192.0005); _exp2 gives its values."""
    n = np.arange(-125, 128, dtype=np.float32)
    want = np.asarray(jnp.exp2(jnp.asarray(n)))
    got = tq._exp2(torch.from_numpy(n)).numpy()
    assert bits_equal(got, want).all()
    assert float(got[list(n).index(13.0)]) != 8192.0


def test_round_half_to_even():
    """torch.round and jnp.round both round half to even: at exact halves
    of a brain-float step the result keeps the even mantissa."""
    h = np.array([0.5, 1.5, 2.5, -0.5, -2.5], np.float32)
    np.testing.assert_array_equal(torch.round(torch.from_numpy(h)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(h))))
    # 1 + 2^-8 sits halfway between 1 and 1 + 2^-7: even is 1.0;
    # 1 + 3 * 2^-8 sits between 1 + 2^-7 and 1 + 2^-6: even is 1 + 2^-6
    ties = np.array([1 + 2 ** -8, 1 + 3 * 2 ** -8, -(1 + 2 ** -8)], np.float32)
    got, want = both("brain_float_quantize", ties)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got.numpy(), [1.0, 1 + 2 ** -6, -1.0])


finite32 = st.floats(width=32, allow_nan=False, allow_infinity=False)
# one shape, so that JAX compiles each quantizer once
arrays = hnp.arrays(np.float32, (16, 24), elements=finite32)


@settings(max_examples=40, derandomize=True, deadline=None)
@given(arrays)
def test_brain_float_hypothesis_bit_equal(x):
    got, want = both("brain_float_quantize", x)
    assert bits_equal(got.numpy(), want).all()


@settings(max_examples=40, derandomize=True, deadline=None)
@given(arrays, st.sampled_from([(0, 8), (-1, 8), (0, 0), (-1, 0), (-1, 4)]),
       st.sampled_from([4, 8]))
def test_bfp_hypothesis_bit_equal(x, axis_block, man_bits):
    axis, block = axis_block
    got, want = both("bfp_quantize", x, man_bits, axis, block)
    assert bits_equal(got.numpy(), want).all()


def test_bfp_random_blocks_bit_equal():
    rng = np.random.default_rng(0)
    # the hypothesis tests' shape, so that JAX's quantizer compiles once
    x = (rng.normal(size=(16, 24)) * 10.0 ** rng.integers(-30, 30, (16, 1))).astype(np.float32)
    for axis, block in ((0, 8), (-1, 8), (-1, 0), (0, 5)):
        got, want = both("bfp_quantize", x, 8, axis, block)
        assert bits_equal(got.numpy(), want).all(), (axis, block)


def test_brainfloat_matches_bfloat16():
    """tests/ops/test_quantize.py: brainfloat16 is a bfloat16 round trip
    (within the JAX test's 1e-7: lax.exp2's scales are not exact)."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=1000).astype(np.float32) * 100)
    q = tq.brainfloat16(x)
    np.testing.assert_allclose(q.numpy(), x.bfloat16().float().numpy(), rtol=1e-7)


def test_brainfloat_preserves_zero_and_sign():
    q = tq.brain_float_quantize(torch.tensor([0.0, -1.5, 1.5, -1e-30]), 8, 7)
    assert float(q[0]) == 0.0 and float(q[1]) == -1.5 and float(q[2]) == 1.5


def test_bfp_shared_exponent_and_blocks():
    x = torch.tensor([[1.0, 0.5, 0.26, 0.003]])
    q = tq.bfp_quantize(x, man_bits=4, axis=-1)
    np.testing.assert_allclose(q.numpy(), np.round(x.numpy() * 8) / 8, atol=1e-7)
    x = torch.tensor([[100.0, 0.1, 0.1, 0.1]])
    err1 = float((tq.bfp_quantize(x, man_bits=4, axis=-1) - x)[0, 1:].abs().max())
    err2 = float((tq.bfp_quantize(x, man_bits=4, axis=-1, block=2) - x)[0, 2:].abs().max())
    assert err1 > 0.09 and err2 < 0.01


def test_ste_passes_the_gradient():
    x = torch.tensor([1.3, -2.7], requires_grad=True)
    (tq.ste(x, tq.brainfloat16) ** 2).sum().backward()
    q = tq.brainfloat16(x.detach())
    np.testing.assert_allclose(x.grad.numpy(), 2.0 * q.numpy(), rtol=1e-6)
    jg = jax.grad(lambda v: jnp.sum(jq.ste(v, jq.brainfloat16) ** 2))(jnp.asarray([1.3, -2.7]))
    np.testing.assert_array_equal(x.grad.numpy(), np.asarray(jg))


# ------------------------------------------------------- quantized LSTM
def close_in_bf_steps(got, want, what: str, max_share: float = MAX_SHARE) -> int:
    """Equal to the bit or within ULP_REL, and beyond that within one
    brain-float step on at most MAX_SHARE of the entries; returns (and
    prints) how many are a step apart."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    mag = np.maximum(np.abs(want), 2.0 ** -126)
    err = np.abs(got.astype(np.float64) - want)
    ulp = ~bits_equal(got, want) & (err <= ULP_REL * mag)
    step = err > ULP_REL * mag
    n = int(step.sum())
    print(f"{what}: {int(ulp.sum())} of {got.size} entries within {ULP_REL:.1e} relative, "
          f"{n} a brain-float step apart")
    if n:
        assert np.all(err[step] <= BF_STEP * mag[step] * 1.0001), what
        assert n <= max_share * got.size, what
    return n


# I = 12: not a multiple of 8, so the activations' BFP takes the whole axis.
# T=7, B=3 as in the stack below, whose second layer the first case repeats,
# so that JAX compiles that scan once for the file.
@pytest.mark.parametrize("I,H,hard", [(16, 16, False), (12, 24, True)])
def test_quantized_layer_matches_jax(I, H, hard):
    params = init_lstm(jax.random.PRNGKey(3), I, H, 1, forget_gate_bias=1.0)["layer_0"]
    rng = np.random.default_rng(1)
    T, B = 7, 3
    x = rng.normal(size=(T, B, I)).astype(np.float32)
    h0 = (rng.normal(size=(B, H)) * 0.3).astype(np.float32)
    c0 = (rng.normal(size=(B, H)) * 0.3).astype(np.float32)
    wys, wcs = jax_run_lstm_layer(params, jnp.asarray(x), jnp.asarray(h0), jnp.asarray(c0),
                                  hard=hard, quantize=True)
    ys, cs = run_lstm_layer(to_torch(params), torch.from_numpy(x), torch.from_numpy(h0),
                            torch.from_numpy(c0), hard=hard, quantize=True)
    assert ys.dtype == torch.float32
    close_in_bf_steps(ys, wys, f"layer ys I={I} H={H} hard={hard}")
    close_in_bf_steps(cs, wcs, f"layer cs I={I} H={H} hard={hard}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_stack_and_step_match_jax(dtype):
    """The stack (scan) and the step, each against JAX's, on a bf16 input
    too (the weights are cast to the input's dtype before quantizing)."""
    params = init_lstm(jax.random.PRNGKey(4), 12, 16, 2, forget_gate_bias=1.0)
    rng = np.random.default_rng(2)
    x = rng.normal(size=(7, 3, 12)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jx, tx = jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)
    w_out, (w_h, w_c), _ = jax_run_lstm(params, jx, quantize=True)
    out, (h, c), _ = run_lstm(to_torch(params), tx, quantize=True)
    close_in_bf_steps(out, w_out, f"stack out {dtype}")
    close_in_bf_steps(h, w_h, f"stack h_n {dtype}")
    close_in_bf_steps(c, w_c, f"stack c_n {dtype}")
    hs = (rng.normal(size=(2, 3, 16)) * 0.3).astype(np.float32)
    cs = (rng.normal(size=(2, 3, 16)) * 0.3).astype(np.float32)
    want = jax_lstm_step(params, jx[0], jnp.asarray(hs).astype(jd), jnp.asarray(cs).astype(jd),
                         quantize=True)
    got = lstm_step(to_torch(params), tx[0], torch.from_numpy(hs).to(td),
                    torch.from_numpy(cs).to(td), quantize=True)
    for g, w, name in zip(got, want, ("y", "h", "c")):
        assert g.dtype == td
        close_in_bf_steps(g.float(), np.asarray(w, np.float32), f"step {name} {dtype}")


def test_quantized_scan_matches_step_chain():
    """tests/ops/test_quantized_lstm.py: the scan (offline encode) and the
    step (serving) apply the same quantization points."""
    params = to_torch(init_lstm(jax.random.PRNGKey(0), 16, 16, 2, forget_gate_bias=1.0))
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(5, 3, 16)).astype(np.float32))
    out, (h_n, _), _ = run_lstm(params, x, quantize=True)
    h, c = torch.zeros(2, 3, 16), torch.zeros(2, 3, 16)
    outs = []
    for t in range(5):
        y, h, c = lstm_step(params, x[t], h, c, quantize=True)
        outs.append(y)
    np.testing.assert_allclose(out.numpy(), torch.stack(outs).numpy(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(h_n.numpy(), h.numpy(), atol=1e-6)


def test_quantized_weights_are_kept_and_refreshed_in_place(monkeypatch):
    """Each layer's weights are quantized once a compute dtype and kept,
    for the scan and every step; weights written in place afterwards (a
    checkpoint applied after ``eval()``) are requantized into the same
    tensors, which a captured graph reads, and give what a fresh tree
    gives."""
    from caiman_asr_tpu_torch.ops import lstm as tl

    params = to_torch(init_lstm(jax.random.PRNGKey(6), 16, 16, 2, forget_gate_bias=1.0))
    calls = []
    quantize_layer = tl._quantize_layer
    monkeypatch.setattr(tl, "_quantize_layer",
                        lambda p, dtype: calls.append(dtype) or quantize_layer(p, dtype))
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(5, 3, 16)).astype(np.float32))
    first, _, _ = run_lstm(params, x, quantize=True)
    h = torch.zeros(2, 3, 16)
    for _ in range(3):
        lstm_step(params, x[0], h, h, quantize=True)
    assert calls == [torch.float32] * 2  # once a layer
    kept = params["layer_0"]["w_ih"]._quantized[torch.float32][1]
    ptrs = [t.data_ptr() for t in kept]
    with torch.no_grad():
        params["layer_0"]["w_hh"].mul_(0.5)  # in place, as apply_params writes
    again, _, _ = run_lstm(params, x, quantize=True)
    assert calls == [torch.float32] * 3
    assert params["layer_0"]["w_ih"]._quantized[torch.float32][1] is kept
    assert [t.data_ptr() for t in kept] == ptrs
    clone = {n: {k: t.clone() for k, t in layer.items()} for n, layer in params.items()}
    assert not torch.equal(first, again)
    assert torch.equal(again, run_lstm(clone, x, quantize=True)[0])
    # a bf16 input: the first layer's own copy (its output is fp32)
    run_lstm(params, x.bfloat16(), quantize=True)
    assert set(params["layer_0"]["w_ih"]._quantized) == {torch.float32, torch.bfloat16}


def test_quantized_differs_but_close():
    params = to_torch(init_lstm(jax.random.PRNGKey(1), 16, 16, 2, forget_gate_bias=1.0))
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(8, 4, 16)).astype(np.float32))
    q, _, _ = run_lstm(params, x, quantize=True)
    f, _, _ = run_lstm(params, x, quantize=False)
    assert not torch.equal(q, f)
    assert float((q - f).abs().max()) < 0.15 and float((q - f).abs().mean()) < 0.02


def test_quantize_ignored_during_training():
    params = to_torch(init_lstm(jax.random.PRNGKey(2), 16, 16, 2, forget_gate_bias=1.0))
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 2, 16)).astype(np.float32))
    q, _, _ = run_lstm(params, x, quantize=True, train=True)
    f, _, _ = run_lstm(params, x, quantize=False, train=True)
    torch.testing.assert_close(q, f, rtol=0, atol=0)


def test_quantized_needs_true_fp32_products():
    params = to_torch(init_lstm(jax.random.PRNGKey(2), 16, 16, 1))
    x = torch.zeros(2, 1, 16)
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            run_lstm(params, x, quantize=True)
    finally:
        torch.set_float32_matmul_precision(before)


# ------------------------------------------------------ quantized model
CFG = dict(in_feats=16, enc_n_hid=16, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
           enc_stack_time_factor=2, pred_n_hid=16, pred_rnn_layers=1, joint_n_hid=16,
           enc_dropout=0.0, pred_dropout=0.0, joint_dropout=0.0)
N_CLASSES = 8


def test_quantized_greedy_matches_jax():
    """A ``quantize: true`` model's encoder and greedy hypotheses against
    JAX's on the same parameters."""
    jcfg = JaxConfig(**CFG, quantize=True)
    jm = JaxRNNT(jcfg, N_CLASSES)
    params = jm.init(jax.random.PRNGKey(5))
    # the blank's bias lowered so that the random model emits
    fc = dict(params["joint_fc"])
    fc["b"] = fc["b"].at[N_CLASSES - 1].add(-2.0)
    params = dict(params, joint_fc=fc)
    tm = load_jax_params(RNNT(RNNTModelConfig(**CFG, quantize=True), N_CLASSES, device="cpu"),
                         jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(6)
    x = rng.normal(size=(20, 4, 16)).astype(np.float32) * 2
    lens = np.array([20, 16, 11, 5], np.int32)
    w_enc, w_lens, _ = jm.encode(params, jnp.asarray(x), jnp.asarray(lens))
    with torch.inference_mode():
        enc, enc_lens, _ = tm.encode(torch.from_numpy(x), torch.from_numpy(lens))
    np.testing.assert_array_equal(enc_lens.numpy(), np.asarray(w_lens))
    close_in_bf_steps(enc.numpy(), w_enc, "quantized encoder output", ENC_MAX_SHARE)
    # the plain model's encoder on the same weights differs
    plain = load_jax_params(RNNT(RNNTModelConfig(**CFG), N_CLASSES, device="cpu"),
                            jax.tree.map(np.asarray, params))
    with torch.inference_mode():
        assert not torch.equal(plain.encode(torch.from_numpy(x), torch.from_numpy(lens))[0], enc)
    want = JaxGreedy(jm, N_CLASSES - 1, max_symbols_per_step=3).decode_encs(params, w_enc, w_lens)
    got = GreedyDecoder(tm, N_CLASSES - 1, max_symbols_per_step=3).decode_encs(enc, enc_lens)
    np.testing.assert_array_equal(got[3], want[3])
    assert int(np.asarray(want[3]).sum()) > 0
    for b in range(4):
        n = int(got[3][b])
        np.testing.assert_array_equal(got[0][b, :n], np.asarray(want[0])[b, :n])


def test_quantize_ignored_by_the_model_in_training():
    """``enc_pred(train=True)`` runs the plain recurrence on a quantized
    config, as JAX's ``run_lstm`` (``quantize and not train``)."""
    jm = JaxRNNT(JaxConfig(**CFG), N_CLASSES)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(7)))
    q = load_jax_params(RNNT(dataclasses.replace(RNNTModelConfig(**CFG), quantize=True),
                             N_CLASSES, device="cpu"), params)
    f = load_jax_params(RNNT(RNNTModelConfig(**CFG), N_CLASSES, device="cpu"), params)
    x = torch.from_numpy(np.random.default_rng(8).normal(size=(10, 2, 16)).astype(np.float32))
    lens = torch.tensor([10, 7], dtype=torch.int32)
    y = torch.tensor([[1, 2, 3], [4, 5, 0]])
    ylens = torch.tensor([3, 2], dtype=torch.int32)
    for train in (True, False):
        gq = q.enc_pred(x, lens, y, ylens, train=train)[0][0]
        gf = f.enc_pred(x, lens, y, ylens, train=train)[0][0]
        assert torch.equal(gq, gf) == train


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantized_engine_ticks(dtype):
    """The streaming engine with a ``quantize: true`` model: its tick runs
    the quantized encoder and predictor step (fp32 and bf16 engines); in
    fp32 each advancing lane's tokens equal the JAX engine's on the same
    parameters and script."""
    from tests.test_torch_serving import CFG as SCFG
    from tests.test_torch_serving import BLANK as SBLANK
    from tests.test_torch_serving import N_CLASSES as SK
    from tests.test_torch_serving import Tok, drive
    from caiman_asr_tpu.ops.logmel import LogMelConfig as JaxLogMelConfig
    from caiman_asr_tpu.serving.engine import StreamingEngine as JaxEngine
    from caiman_asr_tpu_torch.ops.logmel import LogMelConfig
    from caiman_asr_tpu_torch.serving.engine import StreamingEngine

    jm = JaxRNNT(JaxConfig(**SCFG, quantize=True), SK)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(3)))
    params["joint_fc"]["b"] = params["joint_fc"]["b"] + np.eye(SK, dtype=np.float32)[SBLANK] * 0.3
    tm = load_jax_params(RNNT(RNNTModelConfig(**SCFG, quantize=True), SK, device="cpu"), params)
    rng = np.random.default_rng(0)
    mel_stats = (rng.normal(size=80).astype(np.float32) * 0.1 - 8.0,
                 np.abs(rng.normal(size=80)).astype(np.float32) + 0.5)
    kw = dict(max_streams=4, max_symbols_per_step=4)
    got_resp, got_packed = drive(StreamingEngine(
        tm, SBLANK, Tok(), mel_stats=mel_stats, logmel=LogMelConfig(dither=0.0), device="cpu",
        dtype=getattr(torch, dtype), **kw))
    assert len(got_packed) >= 30 and sum(int(g[:, -1].sum()) for g, _ in got_packed) > 0
    if dtype == "bfloat16":
        return
    want_resp, want_packed = drive(JaxEngine(jm, params, SBLANK, Tok(), mel_stats=mel_stats,
                                             logmel=JaxLogMelConfig(dither=0.0), **kw))
    assert len(got_packed) == len(want_packed)
    for (g, ga), (w, wa) in zip(got_packed, want_packed):
        np.testing.assert_array_equal(ga, wa)
        np.testing.assert_array_equal(g[:, -1], w[:, -1])
        np.testing.assert_array_equal(g[ga], w[wa])
