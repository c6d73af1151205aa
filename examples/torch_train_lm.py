"""End-to-end training on PyTorch: a small LM trained for a few
hundred steps with checkpointing, crash-resume and straggler detection.
On the card (``--device cpu`` for the CPU).

  PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
Thin wrapper over the training launcher (repro_torch.launch.train).
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main

if __name__ == "__main__":
    main(["--arch", "smollm-135m", "--scale", "smoke", "--steps", "200",
          "--batch", "8", "--seq", "64",
          "--ckpt", os.path.join(tempfile.gettempdir(),
                                 "repro_torch_example_ckpt")]
         + sys.argv[1:])
