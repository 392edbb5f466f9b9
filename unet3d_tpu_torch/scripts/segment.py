"""One-hot / probability NIfTIs -> label maps (counterpart of
``unet3d_tpu/scripts/segment.py``, same flags).

    python -m unet3d_tpu_torch.scripts.segment --filenames p.nii.gz \
        --labels 2 1 4 --hierarchy --output_filenames seg.nii.gz

Threshold, sum-then-threshold or hierarchy decoding; outputs named by
explicit filenames or by search-replace pairs.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from unet3d_tpu_torch.data.io import load_image
from unet3d_tpu_torch.ops.one_hot import one_hot_to_label_map


def format_parser(parser=None, sub_command: bool = False):
    if parser is None:
        parser = argparse.ArgumentParser()
    if sub_command:
        parser.add_argument("--segment", action="store_true", default=False)
    else:
        parser.add_argument("--filenames", nargs="*", required=True)
        parser.add_argument("--labels", nargs="*", required=True)
        parser.add_argument("--hierarchy", default=False, action="store_true")
        parser.add_argument("--verbose", action="store_true", default=False)
        parser.add_argument("--output_replace", nargs="*")
        parser.add_argument("--output_filenames", nargs="*")
    parser.add_argument("--threshold", default=0.5, type=float,
                        help="Threshold for segmentation cutoff.")
    parser.add_argument("--sum", default=False, action="store_true",
                        help="Sum the predictions before using threshold.")
    parser.add_argument("--use_contours", action="store_true", default=False,
                        help="Use predicted contour channels to assist segmentation.")
    parser.add_argument("--no_overwrite", action="store_true", default=False,
                        help="Default is to overwrite.")
    return parser


def parse_args(args=None):
    return format_parser(argparse.ArgumentParser(), sub_command=False).parse_args(args)


def main(args=None):
    namespace = parse_args(args)
    overwrite = not namespace.no_overwrite
    if namespace.output_filenames:
        output_filenames = namespace.output_filenames
    elif namespace.output_replace:
        output_filenames = []
        for fn in namespace.filenames:
            ofn = fn
            for i in range(0, len(namespace.output_replace), 2):
                ofn = ofn.replace(namespace.output_replace[i],
                                  namespace.output_replace[i + 1])
            output_filenames.append(ofn)
    else:
        raise RuntimeError("Please specify output_filenames or output_replace.")
    labels = [int(label) for label in namespace.labels]
    for fn, ofn in zip(namespace.filenames, output_filenames):
        if overwrite or not os.path.exists(ofn):
            if namespace.verbose:
                print(fn, "-->", ofn)
            out_dir = os.path.dirname(ofn)
            if out_dir and not os.path.exists(out_dir):
                os.makedirs(out_dir)
            image = load_image(fn, reorder=False)
            label_map = one_hot_to_label_map(np.asarray(image.data), labels=labels,
                                             threshold=namespace.threshold,
                                             sum_then_threshold=namespace.sum,
                                             label_hierarchy=namespace.hierarchy)
            image.make_similar(label_map.numpy()[None]).to_filename(ofn)


if __name__ == "__main__":
    main()
