"""The traffic generators: ``traffic/<name>.json`` names one by its
``kind``, the module here that reads it. A module holds a ``Session`` with
``setup()``, ``call()`` (one unit of the timed window), ``quantities()``,
``release()`` and ``check(limits)``. Inputs and weights are made from the
seed by functions that do not import the program, so the control can make
the same ones without it."""


def torch_dtype(name):
    import torch

    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def build_model(cfg, weights, device):
    """The port's model of ``cfg`` holding ``weights`` (loaded by name,
    strictly: every name and shape must match the reference's), its
    parameters allocated on ``device`` without an initial draw."""
    import torch

    from rubiksnet_torch.models.rubiksnet import RubiksNet

    with torch.device(device):
        model = RubiksNet(cfg["tier"], cfg["num_classes"], cfg["num_frames"],
                          cfg["variant"], quantize=cfg["quantize"],
                          max_shift=cfg["max_shift"],
                          dtype=torch_dtype(cfg["dtype"]))
    model.load_state_dict(weights, strict=True)
    return model


def clips(cfg, count, generator, device, dtype):
    """``count`` clips (count, frames, size, size, 3) of N(0, 1) values in
    ``dtype``, drawn in one call."""
    import torch

    s = cfg["input_size"]
    return torch.randn((count, cfg["num_frames"], s, s, 3),
                       generator=generator, device=device).to(dtype)
