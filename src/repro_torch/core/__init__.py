"""Hardware models: counterpart of `repro.core`. Ported so far: the
roofline part of `tpu_gold` (`ChipSpec`, `RooflineTerms`,
`roofline_terms`), with the H100 as the port's chip."""

from .tpu_gold import H100_SXM, ChipSpec, RooflineTerms, roofline_terms

__all__ = ["ChipSpec", "H100_SXM", "RooflineTerms", "roofline_terms"]
