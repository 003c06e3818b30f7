"""Detection visualization (parity: BaseDetector.show_result +
tools/visualization.py in the reference).

Port of kgdet_tpu/tools/visualize.py: draws boxes, class labels, scores
and visible keypoints on an image with OpenCV (``image_io.require_cv2``
names it where it does not import). The detector runs on the CUDA card
unless ``--device`` says otherwise; the masks the mask configs' Detector
also returns are not drawn, as the JAX tool has none:

  python -m kgdet_tpu_torch.tools.visualize configs/..._demo.py IMG.jpg \
      [--checkpoint CKPT | --load-pth PTH] [--out out.jpg] \
      [--score-thr 0.3] [--device cpu]

``main(argv)`` also returns the drawn image and the number of detections
drawn.
"""
from __future__ import annotations

import argparse

from kgdet_tpu_torch.data.deepfashion2_meta import CLASSES

_COLORS = [(66, 133, 244), (219, 68, 55), (244, 180, 0), (15, 157, 88),
           (171, 71, 188), (0, 172, 193), (255, 112, 67), (158, 157, 36),
           (92, 107, 192), (240, 98, 146), (0, 121, 107), (93, 64, 55),
           (69, 90, 100)]


def draw_detections(img, boxes, labels, kpts, score_thr=0.3,
                    class_names=CLASSES):
    """img: BGR uint8; boxes (N, 5); labels (N,); kpts (N, K, 3)."""
    from kgdet_tpu_torch.data.image_io import require_cv2
    cv2 = require_cv2('drawing detections')

    out = img.copy()
    for i in range(len(boxes)):
        x1, y1, x2, y2, score = boxes[i]
        if score < score_thr:
            continue
        c = _COLORS[int(labels[i]) % len(_COLORS)]
        cv2.rectangle(out, (int(x1), int(y1)), (int(x2), int(y2)), c, 2)
        name = class_names[int(labels[i])] if int(labels[i]) < len(
            class_names) else str(int(labels[i]))
        cv2.putText(out, f'{name} {score:.2f}', (int(x1), int(y1) - 4),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, c, 1, cv2.LINE_AA)
        for k in range(kpts.shape[1]):
            x, y, v = kpts[i, k]
            if v > 0:
                cv2.circle(out, (int(x), int(y)), 2, c, -1)
    return out


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('config')
    p.add_argument('image')
    p.add_argument('--checkpoint', default=None)
    p.add_argument('--load-pth', default=None)
    p.add_argument('--out', default='vis.jpg')
    p.add_argument('--score-thr', type=float, default=0.3)
    p.add_argument('--device', default=None,
                   help='torch device; default the CUDA card, an error '
                        'where there is none')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from kgdet_tpu_torch.api import init_detector
    from kgdet_tpu_torch.data.image_io import imread, require_cv2

    det = init_detector(args.config, checkpoint=args.checkpoint,
                        pth=args.load_pth, device=args.device)
    img = imread(args.image)
    boxes, labels, kpts = det(img)[:3]
    out = draw_detections(img, boxes, labels, kpts, args.score_thr)
    require_cv2('writing the image').imwrite(args.out, out)
    n = int((boxes[:, 4] >= args.score_thr).sum())
    print(f'{n} detections >= {args.score_thr}; wrote {args.out}')
    return out, n


if __name__ == '__main__':
    main()
