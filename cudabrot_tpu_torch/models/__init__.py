from cudabrot_tpu_torch.models.fractals import FRACTALS, FractalMap, get_fractal

__all__ = ["FRACTALS", "FractalMap", "get_fractal"]
