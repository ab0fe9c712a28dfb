"""The LSTM recurrence kernel (caiman_asr_tpu_torch/ops/csrc/
lstm_recurrence.cu) against its plain PyTorch version, on the card.

A CUDA kernel has no interpret mode, so these tests need a GPU and nvcc and
skip elsewhere; run them on the card with
``python -m pytest tests/test_torch_kernel.py -q``. Tolerances: fp32 1e-4
(sums in another order); bf16 2e-2 (h rounded to bf16 for the product, sums
in another order over H).
"""

import numpy as np
import pytest
import torch

from caiman_asr_tpu_torch.ops import lstm_kernel

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(T, B, H, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *shape, s=1.0: torch.from_numpy(
        (rng.normal(size=shape) * s).astype(np.float32)).to(device, dtype)
    return (mk(T, B, 4 * H, s=0.5), mk(4 * H, H, s=1 / np.sqrt(3 * H)),
            mk(B, H, s=0.1), mk(B, H, s=0.1))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("hard", [False, True])
@pytest.mark.parametrize("T,B,H", [(10, 8, 32), (7, 5, 40), (3, 33, 1024)])
def test_kernel_matches_plain(cuda, dtype, tol, hard, T, B, H):
    args = _inputs(T, B, H, dtype, cuda)
    before = lstm_kernel.lstm_recurrence.launches
    ys, cs = lstm_kernel.lstm_recurrence(*args, hard)
    torch.cuda.synchronize()
    assert lstm_kernel.lstm_recurrence.launches == before + T
    ys_ref, cs_ref = lstm_kernel.lstm_recurrence_plain(*args, hard)
    assert ys.dtype == cs.dtype == dtype
    torch.testing.assert_close(ys.float(), ys_ref.float(), rtol=0, atol=tol)
    torch.testing.assert_close(cs.float(), cs_ref.float(), rtol=0, atol=tol)


def test_kernel_rejects_what_it_does_not_take(cuda):
    gx, w, h0, c0 = _inputs(4, 2, 32, torch.float32, cuda)
    with pytest.raises(TypeError):
        lstm_kernel.lstm_recurrence(gx.half(), w.half(), h0.half(), c0.half())
    with pytest.raises(ValueError):
        lstm_kernel.lstm_recurrence(gx, w.t().contiguous().t(), h0, c0)
    with pytest.raises(ValueError):
        lstm_kernel.lstm_recurrence(gx, w, h0.cpu(), c0)
    gx, w, h0, c0 = _inputs(4, 2, 12, torch.float32, cuda)
    with pytest.raises(ValueError):  # H not a multiple of 8
        lstm_kernel.lstm_recurrence(gx, w, h0, c0)
