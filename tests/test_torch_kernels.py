"""The port's CUDA kernels against their plain PyTorch versions.

Imports only torch, numpy and the port, so it also runs on a GPU machine
without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

The ``cuda`` tests skip without a card (a CUDA kernel has no CPU mode);
the wrapper's input checks run everywhere.
"""

import numpy as np
import pytest
import torch

from lighthouse_tpu_torch.crypto.bls.constants import P
from lighthouse_tpu_torch.ops import field, mont_mul

R = 1 << 384
EDGES = [0, 1, P - 1, P, 2 * P - 1, R % P]


def _operands(seed, n):
    """int32 [n + 36, 48] pairs: random rows in [0, 2p), then every pair of
    edge rows."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, size=(n + 36, 48), dtype=np.int32)
    b = rng.integers(0, 256, size=(n + 36, 48), dtype=np.int32)
    a[:, 47] %= 0x34  # below 2p (whose top byte is 0x34)
    b[:, 47] %= 0x34
    a[n:] = field.ints_to_limbs([x for x in EDGES for _ in EDGES])
    b[n:] = field.ints_to_limbs([y for _ in EDGES for y in EDGES])
    return torch.from_numpy(a), torch.from_numpy(b)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")


@pytest.mark.parametrize("bad, err", [
    (lambda a: a.to(torch.int64), TypeError),
    (lambda a: a[..., :47], ValueError),
    (lambda a: a, ValueError),  # a CPU tensor never reaches the kernel
])
def test_kernel_wrapper_rejects(bad, err):
    a, b = _operands(1, 4)
    with pytest.raises(err):
        mont_mul.mont_mul_cuda(bad(a), b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4000,), (3, 5, 7), (0,)])
def test_kernel_matches_plain_and_bigint(shape):
    _card()
    n = int(np.prod(shape))
    a, b = _operands(2, n)
    a, b = a[:n].reshape(*shape, 48).cuda(), b[:n].reshape(*shape, 48).cuda()
    before = mont_mul.K1.launches
    got = mont_mul.mont_mul_cuda(a, b)
    torch.cuda.synchronize()
    assert got.shape == (*shape, 48) and got.dtype == torch.int32
    assert mont_mul.K1.launches == before + (1 if n else 0)
    assert torch.equal(got, mont_mul.mont_mul_plain(a, b))
    ninv = pow(P, -1, R)
    for x, y, z in zip(a.reshape(-1, 48)[:64].cpu().numpy(),
                       b.reshape(-1, 48)[:64].cpu().numpy(),
                       got.reshape(-1, 48)[:64].cpu().numpy()):
        t = field.limbs_to_int(x) * field.limbs_to_int(y)
        assert field.limbs_to_int(z) == (t + ((-t * ninv) % R) * P) // R


@pytest.mark.cuda
def test_kernel_edges_and_broadcast():
    _card()
    a, b = _operands(3, 0)
    a, b = a.cuda(), b.cuda()
    assert torch.equal(mont_mul.mont_mul_cuda(a, b), mont_mul.mont_mul_plain(a, b))
    # a broadcast constant operand and an offset (non-16-byte-aligned) view
    k = b[7]
    assert torch.equal(mont_mul.mont_mul_cuda(a, k), mont_mul.mont_mul_plain(a, k))
    buf = torch.zeros(1 + 48 * 5, dtype=torch.int32, device=a.device)
    buf[1:] = a[:5].reshape(-1)
    odd = buf[1:].view(5, 48)
    assert odd.data_ptr() % 16
    assert torch.equal(mont_mul.mont_mul_cuda(odd, b[:5]),
                       mont_mul.mont_mul_plain(odd, b[:5]))
