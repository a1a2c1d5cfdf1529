from .metrics import StageMetrics, run_with_metrics, trace

__all__ = ["StageMetrics", "run_with_metrics", "trace"]
