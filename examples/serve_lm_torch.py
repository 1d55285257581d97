"""Serve a small model with batched requests while Keyed Prefetching stages
multi-turn session state, on the PyTorch port (see
src/repro_torch/launch/serve.py for the machinery).  On the card unless
``--device cpu``.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py
      PYTHONPATH=src python examples/serve_lm_torch.py --device cpu
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import main  # noqa: E402

if __name__ == "__main__":
    main()
