"""Roofline of the port's target card (counterpart of ``repro.roofline``):
the H100's figures and the three-term analysis."""
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import (RooflineTerms,
                                           parse_collective_bytes, roofline,
                                           terms_from_monitoring,
                                           verdict_from_monitoring)

__all__ = ["hw", "RooflineTerms", "parse_collective_bytes", "roofline",
           "terms_from_monitoring", "verdict_from_monitoring"]
