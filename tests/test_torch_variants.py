"""tools/variants.py: each variant's edits still apply to the CUDA sources
(a variant that no longer applies would time nothing), and the script
needs a card."""

import pytest
import torch

from tpuflow_torch.ops.cuda_lib import CSRC
from tpuflow_torch.tools.variants import VARIANTS, apply_edits, main


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_edits_apply_to_the_sources(name):
    for src in sorted({e[0] for e in VARIANTS[name]}):
        text = (CSRC / src).read_text()
        edited = apply_edits(text, [e[1:] for e in VARIANTS[name] if e[0] == src])
        assert edited != text
        assert all(new in edited for s, _, _, new in VARIANTS[name] if s == src)


def test_an_edit_that_does_not_apply_raises():
    with pytest.raises(ValueError, match="does not apply"):
        apply_edits("constexpr int LT_TH = 12;", [("constexpr int LT_TH = 16;", None, "x")])


def test_variants_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main([])
