"""Seconds of the cell's plan builds in set-up (``build_plan`` for each
candidate, and ``PlanSet.from_plans`` where the mix has several), host
clock."""


def read(run):
    return run.plan_build_s
