"""Closed-form PoCD / cost theory (paper Theorems 1-6) on tensors."""
from .utility import JobSpec, cost_of, pocd_of, utility

__all__ = ["JobSpec", "cost_of", "pocd_of", "utility"]
