"""The A/B tools of the port (unicore_tpu_torch/tools/flash_bwd_ab.py,
fwd_ab.py, dense_decode_ab.py and norm_fwd_ab.py's ``--variants``) build
copies of a kernel source with one design choice undone by text edits.
Each edit's anchor must occur exactly once in the tree's
csrc/ file, or a later change to the kernel would void the copy without a
word (a copy that does not build, or that undoes the wrong thing).  Runs on
the CPU: only the sources are read."""

import pytest

from unicore_tpu_torch.ops import _kernels
from unicore_tpu_torch.tools import dense_decode_ab, flash_bwd_ab, fwd_ab, norm_fwd_ab

#: dense_decode_ab's source copies as fwd_ab's: name -> (source, edits)
DENSE_DECODE_COPIES = {name: (source, edits)
                       for name, (_, source, edits) in dense_decode_ab.VARIANTS.items()
                       if source is not None}
EDITS = (
    [("flash_bwd_ab", name, "flash_attention.cu", i, old)
     for name, edits in flash_bwd_ab.VARIANTS.items() for i, (old, _) in enumerate(edits)]
    + [("fwd_ab", name, source, i, old)
       for name, (source, edits) in fwd_ab.VARIANTS.items() for i, (old, _) in enumerate(edits)]
    + [("dense_decode_ab", name, source, i, old)
       for name, (source, edits) in DENSE_DECODE_COPIES.items()
       for i, (old, _) in enumerate(edits)]
    + [("norm_fwd_ab", name, "fused_norm.cu", i, old)
       for name, edits in norm_fwd_ab.VARIANTS.items() for i, (old, _) in enumerate(edits)]
)


@pytest.mark.parametrize("tool,variant,source,index,anchor", EDITS,
                         ids=[f"{e[0]}-{e[1]}-{e[3]}" for e in EDITS])
def test_ab_edit_anchor_occurs_once(tool, variant, source, index, anchor):
    text = (_kernels.CSRC / source).read_text()
    assert text.count(anchor) == 1, (tool, variant, index, text.count(anchor))


def test_every_variant_undoes_something():
    """A variant whose edits leave the source as it was would time the tree
    against itself."""
    for tool, variants in (("flash_bwd_ab", {n: ("flash_attention.cu", e) for n, e in
                                             flash_bwd_ab.VARIANTS.items()}),
                           ("fwd_ab", fwd_ab.VARIANTS),
                           ("dense_decode_ab", DENSE_DECODE_COPIES),
                           ("norm_fwd_ab", {n: ("fused_norm.cu", e) for n, e in
                                            norm_fwd_ab.VARIANTS.items()})):
        for name, (source, edits) in variants.items():
            text = (_kernels.CSRC / source).read_text()
            edited = text
            for old, new in edits:
                edited = edited.replace(old, new)
            assert edited != text and all(old != new for old, new in edits), (tool, name)


@pytest.mark.parametrize("name", [n for n, (_, src, _) in dense_decode_ab.VARIANTS.items()
                                  if src is None])
def test_chooser_overrides_name_a_chooser(name):
    """A chooser override replaces a function the wrapper calls by its
    module name, so the tree's kernel runs the undone choice."""
    from unicore_tpu_torch.ops import decode_attention, quant_matmul

    kernel, _, change = dense_decode_ab.VARIANTS[name]
    mod = {"quant_matmul": quant_matmul, "decode_attention": decode_attention}[kernel]
    for attr in change:
        assert callable(getattr(mod, attr)), (name, attr)
        assert f"{attr}(" in (_kernels.CSRC.parent / "ops" / f"{kernel}.py").read_text()
