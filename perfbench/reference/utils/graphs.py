"""device_if, eager: the site's predicate read on the host and the body run
where it holds (the semantics of the reference's lax.cond / while_loop
exits, which the program records as CUDA-graph IF nodes)."""

from __future__ import annotations

from typing import Any, Callable

from perfbench.reference.kernels import graph_cond


def device_if(pred, body: Callable[[], Any], what: str = "body") -> None:
    """Run body() where `pred` (a graph_cond.Pred, or a one-element bool
    tensor) holds; a Pred with several uses is read once and its value
    kept for the others."""
    pred = graph_cond.as_pred(pred)
    if not pred.pending:
        pred.pending = [graph_cond.taken_plain(pred)] * pred.uses
    if pred.pending.pop():
        body()
