"""What-if search with TCO: campaigns as an optimizer, not a sweep.  The
port's copy of the reference's ``repro.search``, over the port's campaign
runner.

Public surface::

    from repro_torch.search import SearchSpec, run_search
    result = run_search(SearchSpec.from_json("specs/search_gemm.json"))
    result.frontier          # candidate keys on the Pareto frontier

CLI: ``python -m repro_torch.search run|validate`` (see ``docs/search.md``).
"""
from .engine import SearchResult, run_search
from .pareto import dominates, pareto_filter
from .report import (build_search_report, check_frontier,
                     make_frontier_golden, render_markdown)
from .spec import CONSTRAINT_KEYS, OBJECTIVES, SearchSpec

__all__ = [
    "SearchSpec", "SearchResult", "run_search",
    "dominates", "pareto_filter",
    "build_search_report", "render_markdown",
    "make_frontier_golden", "check_frontier",
    "OBJECTIVES", "CONSTRAINT_KEYS",
]
