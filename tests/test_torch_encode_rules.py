"""The natural encode's integer rounding test against the plain version's
float form, over every mantissa.

``csrc/nat_pack.cu::nat_code`` (the card's ``nat_pack`` and ``nat_pack_prng``)
rounds ``|x|`` up where ``bits < (x's bits << 9)`` as uint32.  The plain
version ``repro_torch.kernels.ref.ref_nat_pack`` does it in floats:
``u < 2|mant| - 1`` with ``u = (bits >> 8) * 2^-24`` and ``mant`` from
``frexp``.  Both sides of the float test are integers below 2^24 scaled by
powers of two, so the two are the same test; :func:`int_codes` (the kernel's
rule, written out in torch) is held to ``ref_nat_pack`` bit for bit over all
2^23 mantissas of both signs, each mantissa under a random normal exponent
(and under the smallest and the largest), at sampled bits and at every edge
of ``bits >> 8`` around ``2 mant`` (the last value that rounds up and the
first that does not, each with the low byte 0 and 255), and at bits 0 and
2^32 - 1.  Zeros and
subnormals code to 0 on both sides.  The kernel's arithmetic runs only on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``); this holds the
identity its rule rests on.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref

MASK = 0xFFFFFFFF


def int_codes(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """``nat_code`` of ``csrc/nat_pack.cu`` in int64 torch: x (d,) f32, bits
    (d,) int32 holding the uint32 pattern -> (d,) int16."""
    xb = x.view(torch.int32).to(torch.int64) & MASK
    r = bits.to(torch.int64) & MASK
    e = (xb >> 23) & 0xFF
    up = (r < ((xb << 9) & MASK)).to(torch.int64)
    c = e - 127 + up + ref.NAT_BIAS
    c = torch.where(x < 0, -c, c)
    return torch.where(e == 0, 0, c).to(torch.int16)


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)


@pytest.mark.parametrize("sign", [0, 1])
def test_integer_round_up_equals_float_form(sign):
    """Every mantissa; its biased exponent random in [1, 254], with 1 and 254
    at the first and last mantissas of each block of 1024."""
    mant = torch.arange(1 << 23, dtype=torch.int64)
    rng = np.random.default_rng(sign)
    expo = torch.from_numpy(rng.integers(1, 255, 1 << 23, dtype=np.int64))
    expo[::1024], expo[1023::1024] = 1, 254
    x = _as_int32((sign << 31) | (expo << 23) | mant).view(torch.float32)
    cases = [torch.from_numpy(rng.integers(0, 1 << 32, 1 << 23, dtype=np.int64))
             for _ in range(4)]
    cases += [torch.zeros_like(mant), torch.full_like(mant, MASK)]
    for hi in (torch.clamp(2 * mant - 1, min=0), 2 * mant):      # bits >> 8 at the edge
        for low in (0, 255):
            cases.append((hi << 8) | low)
    for words in cases:
        bits = _as_int32(words)
        assert torch.equal(int_codes(x, bits), ref.ref_nat_pack(x, bits))


def test_integer_rule_codes_zeros_and_subnormals_as_zero():
    mant = torch.arange(0, 1 << 23, 4099, dtype=torch.int64)
    for sign in (0, 1):
        x = _as_int32((sign << 31) | mant).view(torch.float32)   # +-0.0 and subnormals
        bits = _as_int32(torch.from_numpy(
            np.random.default_rng(sign).integers(0, 1 << 32, mant.numel(), dtype=np.int64)))
        assert not bool(int_codes(x, bits).any())
        assert torch.equal(int_codes(x, bits), ref.ref_nat_pack(x, bits))
