"""The CUDA kernels against their plain versions on the card, at edge shapes
(rows not a multiple of 8, one worker, a short ``h``).  Needs an NVIDIA GPU:
each test skips without one.  On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from repro_torch.core import prng
from repro_torch.kernels import build, ops, ref

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA); the CPU runs the plain versions")
    return torch.device("cuda", 0)


def test_threefry_bits_bitwise(dev):
    key = prng.fold_in(prng.PRNGKey(0), 3)
    for shape in [(1,), (13, 128), (1000, 2048)]:
        before = build.LAUNCHES["threefry_bits"]
        got = ops.bits_op(key, shape, dev)
        assert build.LAUNCHES["threefry_bits"] == before + 1
        assert torch.equal(got, prng.bits(key, shape, device=dev))


@pytest.mark.parametrize("p", [math.inf, 2.0, 1.0, 3.0])
@pytest.mark.parametrize("m,b", [(13, 128), (300, 2048)])
def test_quantize_pack(dev, p, m, b):
    g = torch.Generator(device=dev).manual_seed(0)
    delta = torch.randn((m, b), generator=g, device=dev)
    delta[1] = 0.0
    bits = ops.bits_op(prng.PRNGKey(1), (m, b), dev)
    kp, ks = ops.quantize_pack_op(delta, bits, p=p)
    pp, ps = ref.ref_quantize_pack(delta, bits, p)
    if p == math.inf:
        assert torch.equal(kp, pp) and torch.equal(ks, ps)
    else:
        ulp = (ks.view(torch.int32).long() - ps.view(torch.int32).long()).abs().max()
        assert int(ulp) <= 4
        same = sum(int(((kp >> s) & 3).eq((pp >> s) & 3).sum()) for s in (0, 2, 4, 6))
        assert same >= 0.9999 * m * b


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("m", [13, 300])
@pytest.mark.parametrize("d_short", [0, 100])
def test_unpack_reduce_family(dev, n, m, d_short):
    g = torch.Generator(device=dev).manual_seed(1)
    packed = torch.randint(0, 256, (n, m, 512), generator=g, device=dev, dtype=torch.uint8)
    scales = torch.rand((n, m, 1), generator=g, device=dev) * 3
    assert torch.equal(ops.unpack_reduce_op(packed, scales), ref.ref_unpack_reduce(packed, scales))
    assert torch.equal(ops.unpack_reduce_mean_op(packed, scales),
                       ref.ref_unpack_reduce_mean(packed, scales))
    h = torch.randn(m * 2048 - d_short, generator=g, device=dev)
    got = ops.unpack_reduce_apply_op(packed, scales, h, alpha=0.0217)
    want = ref.ref_unpack_reduce_apply(packed, scales, h, 0.0217, n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_wrappers_reject_bad_inputs(dev):
    delta = torch.zeros((4, 100), device=dev)
    with pytest.raises(ValueError):
        ops.quantize_pack_op(delta, torch.zeros((4, 100), dtype=torch.int32, device=dev),
                             p=math.inf)
    with pytest.raises(ValueError):
        ops.unpack_reduce_op(torch.zeros((2, 3, 8), dtype=torch.uint8, device=dev),
                             torch.zeros((2, 4, 1), device=dev))
