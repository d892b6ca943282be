"""Command-line tools of the port: engine registration and the
train/eval entry point (``python -m predictionio_tpu_torch.tools.run_workflow``)."""
