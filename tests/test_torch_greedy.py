"""The port's GreedyDecoder against the JAX package's on the same encoder
output and parameters: tokens, frame indices and counts must be equal
exactly (fp32); log-probabilities within 1e-5, and within 1e-6 for the
device loop's sweep over chunk sizes and settings."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from caiman_asr_tpu.decoding.eos import EOSBlank as JaxEOSBlank
from caiman_asr_tpu.decoding.eos import EOSIgnore as JaxEOSIgnore
from caiman_asr_tpu.decoding.eos import EOSPredict as JaxEOSPredict
from caiman_asr_tpu.decoding.fuzzy import get_topk_logits as jax_topk
from caiman_asr_tpu.decoding.greedy import GreedyDecoder as JaxGreedy
from caiman_asr_tpu.models.rnnt import RNNT as JaxRNNT
from caiman_asr_tpu.models.rnnt import RNNTModelConfig as JaxConfig
from caiman_asr_tpu_torch.decoding import eos
from caiman_asr_tpu_torch.decoding.fuzzy import get_topk_logits
from caiman_asr_tpu_torch.decoding.greedy import GreedyDecoder, _Loop
from caiman_asr_tpu_torch.export.from_jax import load_jax_params
from caiman_asr_tpu_torch.models.config import RNNTModelConfig
from caiman_asr_tpu_torch.models.rnnt import RNNT

K = 11
BLANK = K - 1
CFG = dict(
    in_feats=8, enc_n_hid=12, enc_pre_rnn_layers=1, enc_post_rnn_layers=1,
    enc_stack_time_factor=2, pred_n_hid=8, pred_rnn_layers=2, joint_n_hid=12,
)


@functools.cache
def _build(n_classes, seed):
    jm = JaxRNNT(JaxConfig(**CFG), n_classes)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = load_jax_params(RNNT(RNNTModelConfig(**CFG), n_classes, device="cpu"),
                         jax.tree.map(np.asarray, params))
    return jm, params, tm


@pytest.fixture(scope="module")
def models():
    return _build(K, 0)


def _encs(seed, B, T, scale=3.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, CFG["joint_n_hid"])) * scale).astype(np.float32)


def _compare(models, encs, lens, jax_kw=None, kw=None):
    jm, params, tm = models
    want = JaxGreedy(jm, BLANK, **(jax_kw or {})).decode_encs(
        params, jnp.asarray(encs), jnp.asarray(lens))
    got = GreedyDecoder(tm, BLANK, **(kw or jax_kw or {})).decode_encs(
        torch.from_numpy(encs), torch.from_numpy(lens))
    toks, ts, lps, counts = got
    np.testing.assert_array_equal(counts, want[3])
    for b in range(encs.shape[0]):
        n = int(counts[b])
        np.testing.assert_array_equal(toks[b, :n], want[0][b, :n])
        np.testing.assert_array_equal(ts[b, :n], want[1][b, :n])
        np.testing.assert_allclose(lps[b, :n], want[2][b, :n], atol=1e-5)
    return counts


@pytest.mark.parametrize("max_symbols", [2, 30])  # 2 overflows the per-frame cap
def test_decode_encs(models, max_symbols):
    encs = _encs(0, 4, 9)
    counts = _compare(models, encs, np.asarray([9, 7, 5, 0], np.int32),
                      {"max_symbols_per_step": max_symbols})
    assert counts[3] == 0 and counts[:3].sum() > 0


def test_max_symbol_per_sample(models):
    counts = _compare(models, _encs(1, 2, 8), np.asarray([8, 8], np.int32),
                      {"max_symbol_per_sample": 2})
    assert np.all(counts == 2)


@pytest.mark.parametrize("which", ["ignore", "blank", "predict"])
def test_eos_strategies(models, which):
    jax_s = {"ignore": JaxEOSIgnore(3), "blank": JaxEOSBlank(3),
             "predict": JaxEOSPredict(3, alpha=0.5, beta=0.2)}[which]
    s = {"ignore": eos.EOSIgnore(3), "blank": eos.EOSBlank(3),
         "predict": eos.EOSPredict(3, alpha=0.5, beta=0.2)}[which]
    _compare(models, _encs(2, 3, 6), np.asarray([6, 6, 4], np.int32),
             {"eos_strategy": jax_s}, {"eos_strategy": s})


def test_fuzzy_topk_logits():
    x = np.random.default_rng(5).normal(size=(2, 512)).astype(np.float32)
    np.testing.assert_array_equal(get_topk_logits(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_topk(jnp.asarray(x))))


def test_decode_builds_frame_responses(models):
    jm, params, tm = models
    rng = np.random.default_rng(3)
    feats = rng.normal(size=(12, 2, CFG["in_feats"])).astype(np.float32)
    lens = np.asarray([12, 8], np.int32)
    want = JaxGreedy(jm, BLANK).decode(params, jnp.asarray(feats), jnp.asarray(lens))
    # a tiny encoder budget forces one-utterance slices (unbatch.py)
    got = GreedyDecoder(tm, BLANK, max_inputs_per_batch=12 * 8).decode(
        torch.from_numpy(feats), torch.from_numpy(lens))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for t in g:
            gh, wh = g[t].final.alternatives[0], w[t].final.alternatives[0]
            assert (gh.y_seq, gh.timesteps) == (wh.y_seq, wh.timesteps)
            np.testing.assert_allclose(gh.confidence, wh.confidence, atol=1e-5)


# ------------------------------------------------- the loop on the device
# the iteration count of the sweep's batch is ~20, so 4096 is a chunk larger
# than the whole loop
CHUNKS = [1, 5, 4096]
RAGGED = np.asarray([9, 0, 5, 1, 7], np.int32)
K_FUZZY = 256  # get_topk_logits takes whole packets of 8 x 32 logits


# (classes, seed) of the models the sweep decodes with
BASE, FUZZY = (K, 0), (K_FUZZY, 1)


@functools.cache
def _jax_decode(which, key, seed, lens, T):
    """The JAX decoder's outputs, once per setting (they do not depend on
    the port's chunk size)."""
    jm, params, _ = _build(*which)
    kw = dict(key)
    if "eos" in kw:
        kw["eos_strategy"] = _JAX_EOS[kw.pop("eos")]
    encs = _encs(seed, len(lens), T)
    return JaxGreedy(jm, kw.pop("blank"), **kw).decode_encs(
        params, jnp.asarray(encs), jnp.asarray(np.asarray(lens, np.int32)))


_JAX_EOS = {"ignore": JaxEOSIgnore(3), "blank": JaxEOSBlank(3),
            "predict": JaxEOSPredict(3, alpha=0.5, beta=0.2)}
_EOS = {"ignore": eos.EOSIgnore(3), "blank": eos.EOSBlank(3),
        "predict": eos.EOSPredict(3, alpha=0.5, beta=0.2)}


def _compare_loop(which, chunk, seed=11, lens=RAGGED, T=None, **kw):
    """The port's decoder at ``chunk`` iterations a chunk against the JAX
    decoder on encoder output of T frames (default: the longest length):
    tokens, frames and counts equal, log-probs within 1e-6."""
    lens = tuple(int(n) for n in lens)
    T = max(lens) if T is None else T
    want = _jax_decode(which, tuple(sorted(kw.items())), seed, lens, T)
    port_kw = dict(kw)
    blank = port_kw.pop("blank")
    if "eos" in port_kw:
        port_kw["eos_strategy"] = _EOS[port_kw.pop("eos")]
    dec = GreedyDecoder(_build(*which)[2], blank, chunk_iters=chunk, **port_kw)
    encs = _encs(seed, len(lens), T)
    toks, ts, lps, counts = dec.decode_encs(torch.from_numpy(encs),
                                            torch.tensor(lens, dtype=torch.int32))
    np.testing.assert_array_equal(counts, want[3])
    assert toks.shape == np.asarray(want[0]).shape
    for b in range(len(lens)):
        n = int(counts[b])
        np.testing.assert_array_equal(toks[b, :n], want[0][b, :n])
        np.testing.assert_array_equal(ts[b, :n], want[1][b, :n])
        np.testing.assert_allclose(lps[b, :n], want[2][b, :n], atol=1e-6, rtol=0)
    run = dec.last_run
    # the stop flag is read once a chunk and is set by the chunk holding the
    # last iteration that ran (one chunk when every stream starts done, none
    # when there is no frame at all)
    want_chunks = max(1, -(-run["iters"] // chunk)) if T else 0
    assert run["host_reads"] == run["chunks"] == want_chunks
    assert not run["graph"]
    return counts, run


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("max_symbols", [1, 2, 4])
@pytest.mark.parametrize("per_sample", [None, 3])
def test_device_loop_matches_jax(chunk, max_symbols, per_sample):
    counts, run = _compare_loop(BASE, chunk, blank=BLANK,
                                max_symbols_per_step=max_symbols,
                                max_symbol_per_sample=per_sample)
    assert counts[1] == 0 and counts.sum() > 0  # the length-0 stream emits nothing
    if per_sample is not None:
        assert counts.max() <= per_sample


@pytest.mark.parametrize("chunk", [1, 7])
@pytest.mark.parametrize("seed", [4, 28, 33])
def test_device_loop_carries_the_count_across_frames(chunk, seed):
    """Encoder outputs on which the reference's trait shows: the symbol
    count resets only when it reaches max_symbols_per_step (or at the last
    frame), not at each blank, so tokens emitted on one frame shorten the
    next frame's budget. A count reset at each blank gives other counts on
    these seeds."""
    counts, _ = _compare_loop(BASE, chunk, seed=seed, lens=[9, 0, 5, 1, 7], blank=BLANK,
                              max_symbols_per_step=4)
    assert counts.sum() > 0


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("which", ["ignore", "blank", "predict"])
def test_device_loop_eos_strategies(chunk, which):
    _compare_loop(BASE, chunk, seed=12, blank=BLANK, eos=which, max_symbols_per_step=2)


@pytest.mark.parametrize("chunk", CHUNKS)
def test_device_loop_fuzzy_topk(chunk):
    counts, _ = _compare_loop(FUZZY, chunk, seed=13, blank=K_FUZZY - 1,
                              fuzzy_topk_logits=True, max_symbols_per_step=4)
    assert counts.sum() > 0


@pytest.mark.parametrize("T", [0, 4])
def test_device_loop_all_lengths_zero(T):
    """Every stream done from the start: no iteration changes anything."""
    counts, run = _compare_loop(BASE, 5, lens=[0, 0], T=T, blank=BLANK)
    assert counts.sum() == 0 and run["iters"] == 0


class _HostReads(TorchFunctionMode):
    """Raises on any call that reads a device value on the host."""

    READS = {"item", "__bool__", "__int__", "__float__", "__index__", "tolist", "nonzero",
             "cpu", "numpy", "argwhere", "masked_select"}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", "")
        if name in self.READS:
            raise AssertionError(f"host read in the loop body: {name}")
        if name in ("__getitem__", "__setitem__", "index_put_", "index_put"):
            idx = args[1] if len(args) > 1 else ()
            for t in idx if isinstance(idx, (tuple, list)) else (idx,):
                if isinstance(t, torch.Tensor) and t.dtype == torch.bool:
                    raise AssertionError(f"boolean-mask indexing in the loop body: {name}")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("which", [None, "blank", "predict"])
def test_a_chunk_makes_no_host_read(models, which):
    _, _, tm = models
    dec = GreedyDecoder(tm, BLANK, eos_strategy=_EOS.get(which), chunk_iters=3,
                        max_symbol_per_sample=4)
    encs = torch.from_numpy(_encs(15, 3, 6))
    lens = torch.tensor([6, 4, 0])
    with torch.inference_mode():
        state = dec._init_state(encs, lens, 12)
        loop = _Loop(encs, torch.clamp(lens - 1, min=0), torch.tensor(6 * 30 + 8), state)
        with _HostReads():
            dec._chunk(loop)
    assert int(loop.state["iters"]) == 3
