from .engine import EngineResult, LoopConfig, Objective, fit_loop

__all__ = ["EngineResult", "LoopConfig", "Objective", "fit_loop"]
