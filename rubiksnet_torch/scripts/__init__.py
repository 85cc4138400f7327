"""Entry points of the PyTorch port, run as ``python -m
rubiksnet_torch.scripts.<name>``: ``train`` (training, with checkpoints and
resume), ``example_finetune`` (fine-tuning on synthetic clips),
``test_models`` (the evaluator), ``eval_throughput`` (the evaluator on
synthetic frame folders; its ``generate_registry`` writes a synthetic
``somethingv2`` layout for ``train``), ``test_installation``."""
