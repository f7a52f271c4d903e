#!/usr/bin/env python3
"""Name alias for the reference's ``parse_darknet_yolo2.py``: the same
converter as ``yolojax_torch.cli.parse_darknet``."""

from yolojax_torch.cli.parse_darknet import main

if __name__ == "__main__":
    main()
