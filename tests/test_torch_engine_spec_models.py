"""Speculative decoding in the port's serving engine against the JAX
engine's on the reduced llava-1.5-7b and granite-moe-3b-a800m, with
``tests/test_torch_engine_spec.py``'s harness (``_serve``): streams,
rounds, candidate counts, tokens spent, p*, drafts proposed and accepted
and (steps, launches, host syncs) equal, greedy at spec_k 4 and 8 steps a
launch. Apart from the tiny model's file so that ``--dist loadfile``
spreads the two over two workers.
"""
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer
# the harness and the fixtures: one torch thread (autouse)
from test_torch_engine_spec import _one_torch_thread, _serve  # noqa: F401
from test_torch_moe import _pair as moe_pair
from test_torch_moe import granite_cfg
from test_torch_multimodal import _pair as llava_pair
from test_torch_multimodal import _requests as image_requests


def test_spec_llava_evidence_xmodal_equals_reference():
    """Reduced llava: image requests (one text-only) through the paged
    kernel impl; each verified token's evidence alignment folds into the
    candidate's aggregates, and finished candidates are rescored by the
    cross-modal score."""
    pair = llava_pair()
    _, out, _, _ = _serve(pair, "llava paged", ref_impl="paged",
                          impl="paged_cuda", mode="greedy",
                          requests=lambda cls: image_requests(pair[0], cls),
                          xmodal_rescore=True)
    assert all("s_align_xmodal" in c for r in out if r.uid != 3
               for c in r.candidates)


def test_spec_granite_moe_equals_reference(monkeypatch):
    """Reduced granite-moe at capacity factor 1.0: every verify forward
    routes the 6 slots' 4-token blocks as one 24-token group, the invalid
    positions too, in (B, S) order, and capacity drops some of them."""
    drops = []

    def recording(p, cfg, x, **kw):
        out, routing = tmoe.moe_apply(p, cfg, x, **kw)
        if tuple(x.shape[:2]) == (6, 4):          # a verify block
            drops.append(float(tmoe.moe_aux(*routing)["moe_drop_frac"]))
        return out, routing

    monkeypatch.setattr(transformer, "moe_apply", recording)
    _serve(moe_pair(granite_cfg(capacity_factor=1.0)), "granite paged",
           ref_impl="paged", impl="paged_cuda", mode="greedy")
    assert drops and max(drops) > 0
