"""plan_s: set-up seconds in the program's plan building, between analyze
and the window and outside analyze_s and capture_s: the program's spans
plan.super_symbolic, plan.build_plan, plan.pf_plan, plan.wave_plan (the
solve's wave plan) and program.<name>.body (each program's device index
maps), those inside another of them left out."""
from harness import program_spans


def read(run):
    return program_spans.setup_plan_s(run)
