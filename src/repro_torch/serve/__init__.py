from repro_torch.serve.decode import init_cache, make_serve_step, reset_lane
from repro_torch.serve.engine import DecodeEngine
from repro_torch.serve.page_cache import DittoPageCache

__all__ = ["init_cache", "make_serve_step", "reset_lane", "DecodeEngine",
           "DittoPageCache"]
