"""Batched LM serving on the port: the wave-based continuous batching
engine, the twin of ``examples/serve_lm.py``.

  PYTHONPATH=src python examples/torch_serve_lm.py                  # the card
  PYTHONPATH=src python examples/torch_serve_lm.py --smoke --device cpu
  PYTHONPATH=src python examples/torch_serve_lm.py --arch zamba2-2.7b

By default it serves Qwen1.5-0.5B at its published width (random
weights); ``--arch`` takes any config, mamba2-2.7b, zamba2-2.7b and
whisper-medium among them. The engine is the multi-signal idea applied to serving: the
parallel axis is the number of in-flight requests, not the model size.
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
