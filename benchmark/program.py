"""The one place the benchmark reaches into the program under test for
anything but the entry it drives: the scoring object the configuration's
numbers build, and the engine that the program's dispatch picks."""

from __future__ import annotations


def scoring_config(scoring: dict):
    """The program's ``ScoringConfig`` for a configuration's ``scoring``."""
    from tpualign.config import AlignMode, ScoringConfig

    kw = {k: int(v) for k, v in scoring.items() if k != "mode"}
    mode = {"global": AlignMode.GLOBAL, "local": AlignMode.LOCAL}[
        scoring.get("mode", "global")]
    return ScoringConfig(mode=mode, **kw)


def engine(scoring: dict, shape) -> str:
    """The engine ``resolve_impl`` picks for this scoring and pair shape."""
    from tpualign.api import resolve_impl
    from tpualign.config import EngineConfig

    return resolve_impl(EngineConfig(), scoring_config(scoring), shape)
