"""Print a composed config with the PyTorch port's loader (counterpart of
scripts/print_cfg.py, which reads it with the JAX package's):

    python scripts/print_cfg_torch.py --cfg_file configs/...py [--opts k v]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    """Print the config; returns it."""
    from multi_part_assembly_tpu_torch.utils import load_cfg_file
    parser = argparse.ArgumentParser(description='Print config (torch)')
    parser.add_argument('--cfg_file', required=True, type=str)
    parser.add_argument('--opts', nargs='*', default=[],
                        help='config overrides: key value [key value ...]')
    args = parser.parse_args(argv)
    cfg = load_cfg_file(args.cfg_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    print(cfg)
    return cfg


if __name__ == '__main__':
    main()
