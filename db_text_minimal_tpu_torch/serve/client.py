"""REST client of the serving server.

Port of ``db_text_minimal_tpu/serve/client.py``: POST an image to
``/<mode>/<model_name>`` and write the returned prob and thresh masks as
images (``foo1.jpg``, ``foo2.jpg`` in ``--out_dir``). ``--response masks``
reads the nested-list JSON, ``masks_png`` the base64 PNGs. The request goes
through ``urllib.request``, so nothing beyond the standard library and cv2
is needed.

Usage::

    python -m db_text_minimal_tpu_torch.serve.client --image_path img.jpg \
        --host localhost --port 8080 [--response masks_png]
"""

from __future__ import annotations

import argparse
import base64
import io
import json
import os
import time
import urllib.request

import numpy as np


def load_args(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--image_path", type=str, default="./assets/foo.jpg")
    parser.add_argument("--model_name", type=str, default="dbtext")
    parser.add_argument("--mode", type=str, default="predictions")
    parser.add_argument("--host", type=str, default="localhost")
    parser.add_argument("--port", type=str, default="8080")
    parser.add_argument("--out_dir", type=str, default="./tmp")
    parser.add_argument("--response", type=str, default="masks",
                        choices=("masks", "masks_png"),
                        help="masks = the reference's JSON-list contract; "
                             "masks_png = the compact base64-PNG response")
    return parser.parse_args(argv)


def _png(data: str) -> np.ndarray:
    from PIL import Image

    return np.array(Image.open(io.BytesIO(base64.b64decode(data))))


def main(args):
    """POST ``args.image_path``; returns the (prob, thresh) uint8 masks of
    the first image, also written to ``args.out_dir``."""
    import cv2

    url = "http://{}:{}/{}/{}".format(args.host, args.port, args.mode,
                                      args.model_name)
    if args.response == "masks_png":
        url += "?mode=masks_png"
    with open(args.image_path, "rb") as f:
        data = f.read()
    start = time.time()
    request = urllib.request.Request(url, data=data, method="POST")
    with urllib.request.urlopen(request) as r:
        resp = json.loads(r.read())
    print("REST took: {}'s".format(time.time() - start))
    if args.response == "masks_png":
        prob_mask = _png(resp["prob_png"])
        thresh_mask = _png(resp["thresh_png"])
    else:
        prob_mask = np.array(resp["prob_mask"]).astype(np.uint8)
        thresh_mask = np.array(resp["thresh_mask"]).astype(np.uint8)
    print(prob_mask.shape, thresh_mask.shape)
    os.makedirs(args.out_dir, exist_ok=True)
    cv2.imwrite(os.path.join(args.out_dir, "foo1.jpg"), prob_mask)
    cv2.imwrite(os.path.join(args.out_dir, "foo2.jpg"), thresh_mask)
    return prob_mask, thresh_mask


if __name__ == "__main__":
    main(load_args())
