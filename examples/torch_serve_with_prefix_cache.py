"""Serving demo on PyTorch: batched decode with the Ditto-managed
prefix/page cache, the paper's adaptive eviction managing an LLM page
pool.  On the card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/torch_serve_with_prefix_cache.py [--device cpu]
"""
import sys

from repro_torch.launch.serve import main

if __name__ == "__main__":
    main(["--arch", "smollm-135m", "--requests", "16", "--batch", "4",
          "--prompt-len", "64", "--gen", "8"] + sys.argv[1:])
