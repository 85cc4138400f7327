"""Entry points of the PyTorch port, run as ``python -m
rubiksnet_torch.scripts.<name>``: ``test_models`` (the evaluator),
``eval_throughput`` (the evaluator on synthetic frame folders),
``test_installation``."""
