#!/usr/bin/env python3
"""Darknet ``.weights`` -> ``.npz`` converter (port of
``cli/parse_darknet.py``): walk the binary in network order, map the conv
(+BN) and dense parameters, and write the ``.npz`` store both packages
read. Also reads TF1 checkpoints with ``--tf1`` (needs ``tensorflow``), and
builds the model from a Darknet ``.cfg`` with ``--cfg`` instead of the
``[model]`` section.

Usage:
  python -m yolojax_torch.cli.parse_darknet -c config.ini yolo-voc.weights \\
      -o yolo-voc.npz
  python -m yolojax_torch.cli.parse_darknet -c config.ini --tf1 model.ckpt \\
      -o model.npz
"""

from yolojax_torch.utils.cli import make_parser, setup


def main():
    parser = make_parser(__doc__)
    parser.add_argument("--weights", default="",
                        help="path to Darknet .weights (or pass positionally)")
    parser.add_argument("--tf1", default="",
                        help="TF1 checkpoint prefix instead of .weights")
    parser.add_argument("--cfg", default="",
                        help="build the model from a Darknet .cfg file "
                             "instead of the [model] config section")
    parser.add_argument("-o", "--output", required=True,
                        help="output .npz params path")
    args = parser.parse_args()
    # the reference's positional .weights path: pull the positionals that
    # are not key=value out of the overrides
    paths = [a for a in args.overrides if "=" not in a]
    args.overrides = [a for a in args.overrides if "=" in a]
    if paths and not args.weights and not args.tf1:
        args.weights = paths[0]
    cfg = setup(args)

    from yolojax_torch.convert.store import save_network_npz

    if args.cfg:
        from yolojax_torch.convert.cfg import model_from_cfg

        model = model_from_cfg(args.cfg)
    else:
        model = cfg.build_model()
    if args.tf1:
        from yolojax_torch.convert.tf1 import load_tf1_checkpoint

        net = load_tf1_checkpoint(model, args.tf1, input_dim=cfg.model.dim)
        src = args.tf1
    elif args.weights:
        from yolojax_torch.convert.darknet import load_darknet_weights

        net = load_darknet_weights(model, args.weights,
                                   input_dim=cfg.model.dim)
        src = args.weights
    else:
        raise SystemExit("pass a .weights file or --tf1 checkpoint")
    save_network_npz(args.output, model, net)
    n = sum(p.numel() for p in net.parameters())
    print(f"converted {src} -> {args.output} "
          f"({n / 1e6:.1f}M params, {model.name}.{model.inference})")


if __name__ == "__main__":
    main()
