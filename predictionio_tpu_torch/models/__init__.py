"""Engine templates of the port: recommendation (ALS), the sequence
recommender, similar product and e-commerce."""

from . import ecommerce, recommendation, sequencerec, similarproduct

__all__ = ["ecommerce", "recommendation", "sequencerec", "similarproduct"]
