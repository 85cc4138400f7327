"""Install smoke test: RubiksNet-Large with random weights, one forward
pass on a random clip, on the card (counterpart of
scripts/test_installation.py).

Usage: python -m rubiksnet_torch.scripts.test_installation [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from ..models import create_rubiksnet

NUM_FRAMES, IMAGE_SIZE = 8, 224


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device; default the CUDA card, which "
                             "raises where there is none")
    args = parser.parse_args(argv)
    net = create_rubiksnet("large", num_classes=42, num_frames=NUM_FRAMES,
                           device=args.device)
    device = next(net.parameters()).device
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else str(device))
    print(f"=> device: {name}")
    gen = torch.Generator().manual_seed(0)
    video = torch.randn((2, NUM_FRAMES, IMAGE_SIZE, IMAGE_SIZE, 3),
                        generator=gen)
    with torch.no_grad():
        prediction = net(video.to(device))
    print("Random prediction:", prediction.float().cpu().numpy())
    print("Installation successful!")
    return prediction


if __name__ == "__main__":
    main()
