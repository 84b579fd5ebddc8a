"""Sharding plans over a device mesh; counterpart of `repro.sharding`."""
from .planner import (Plan, PlanMesh, Spec, check_spec, constrain,
                      current_plan, make_plan, mesh_sizes, place,
                      place_train_state, placements, plan_context, spec_div)

__all__ = ["Plan", "PlanMesh", "Spec", "check_spec", "constrain",
           "current_plan", "make_plan", "mesh_sizes", "place",
           "place_train_state", "placements", "plan_context", "spec_div"]
