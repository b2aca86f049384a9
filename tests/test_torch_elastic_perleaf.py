"""The elastic in-turn trainer in the per-leaf layout (``--per-leaf-agg``
with ``--participation-q 0.6 --participation-dropout 0.1 --min-workers
3``) against the port's ``reference_step`` on the same gradients, 3 steps
at n = 4, every operator: the memories and ghat bit for bit, over the
masks 1011, 1111 and a degraded 0101 (``tests/test_torch_elastic_train.py``
holds the bucketed layout, with a corrupted wire).
"""

import pytest

from repro_torch.launch import train
from test_torch_elastic_train import (MASKS, METHODS, SPEC, _against_reference, _config,
                                      _one_torch_thread)

__all__ = ["_one_torch_thread"]   # the autouse fixture, imported to apply here


@pytest.mark.parametrize("method", METHODS)
def test_elastic_perleaf_trainer_equals_reference_step(method):
    cfg = _config(compression=method, comp_k=512, comp_bucketed=False)
    opt = train.make_optimizer(cfg, lr=3e-4, participation=SPEC)
    assert not opt.compression.bucketed
    mets = _against_reference(cfg, opt, None)
    assert [(m["mask"], m["ok"]) for m in mets] == MASKS
    assert all(m["valid"] == [] for m in mets)
    assert float(mets[2]["ghat_norm"]) == 0.0   # the degraded step
