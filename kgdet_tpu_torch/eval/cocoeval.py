"""COCO-protocol detection & keypoint (OKS) evaluation in pure NumPy.

Implements the standard COCO mAP protocol (greedy score-ordered matching at 10
IoU thresholds, 101-point interpolated precision) plus the DeepFashion2
keypoint variant: OKS over 294 per-keypoint sigmas, maxDets=[20], area ranges
all/medium/large, and the benchmark's empty-image early-out.

Parity reference: the DeepFashion2 API's PythonAPI/pycocotools/
cocoeval.py:193-271 (computeOks), :272-342 (evaluateImg), :343-470
(accumulate/summarize), :540-560 (Params).

The port's own copy of kgdet_tpu/eval/cocoeval.py, NumPy and the stdlib; the
segm IoU and ``ann_to_rle`` run on the port's RLE code
(kgdet_tpu_torch/native/, built with g++ at first use).
"""
from __future__ import annotations

import numpy as np

from kgdet_tpu_torch.data.deepfashion2_meta import OKS_SIGMAS


class EvalParams:
    def __init__(self, iou_type='bbox', kpt_sigmas=None):
        self.iou_type = iou_type
        self.iou_thrs = np.linspace(0.5, 0.95, 10, endpoint=True)
        self.rec_thrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        if iou_type == 'keypoints':
            self.max_dets = [20]
            self.area_rng = [[0, 1e10], [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
            self.area_lbl = ['all', 'medium', 'large']
            self.kpt_sigmas = (OKS_SIGMAS if kpt_sigmas is None
                               else np.asarray(kpt_sigmas, dtype=np.float64))
        elif iou_type in ('bbox', 'segm'):
            self.max_dets = [1, 10, 100]
            self.area_rng = [[0, 1e10], [0, 32 ** 2],
                             [32 ** 2, 96 ** 2], [96 ** 2, 1e10]]
            self.area_lbl = ['all', 'small', 'medium', 'large']
        else:
            raise ValueError(f'unsupported iou_type: {iou_type}')
        self.img_ids = []
        self.cat_ids = []


def bbox_iou_xywh(dts, gts, iscrowd):
    """IoU between det boxes (D,4) and gt boxes (G,4), xywh format.

    For crowd GTs the denominator is the det area only (IoF), matching the
    COCO mask-API convention.
    """
    dts = np.asarray(dts, dtype=np.float64).reshape(-1, 4)
    gts = np.asarray(gts, dtype=np.float64).reshape(-1, 4)
    if dts.size == 0 or gts.size == 0:
        return np.zeros((dts.shape[0], gts.shape[0]))
    dx1, dy1 = dts[:, 0], dts[:, 1]
    dx2, dy2 = dts[:, 0] + dts[:, 2], dts[:, 1] + dts[:, 3]
    gx1, gy1 = gts[:, 0], gts[:, 1]
    gx2, gy2 = gts[:, 0] + gts[:, 2], gts[:, 1] + gts[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2[None]) -
                 np.maximum(dx1[:, None], gx1[None]), 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2[None]) -
                 np.maximum(dy1[:, None], gy1[None]), 0, None)
    inter = iw * ih
    d_area = (dts[:, 2] * dts[:, 3])[:, None]
    g_area = (gts[:, 2] * gts[:, 3])[None]
    crowd = np.asarray(iscrowd, dtype=bool)[None]
    union = np.where(crowd, d_area, d_area + g_area - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


def compute_oks(dts, gts, sigmas):
    """OKS matrix (D, G) over visible GT keypoints.

    dts: (D, K*3) flat keypoints; gts: list of gt dicts with 'keypoints',
    'bbox', 'area'. Mirrors the DeepFashion2 protocol: mean of
    exp(-d^2 / (2 * area * (2*sigma)^2)) over visible keypoints; when a GT has
    no visible keypoints the distance to its double-expanded box is used.
    """
    k = len(sigmas)
    var = (sigmas * 2) ** 2
    D, G = len(dts), len(gts)
    ious = np.zeros((D, G))
    if D == 0 or G == 0:
        return ious
    d = np.asarray([dt['keypoints'] for dt in dts], dtype=np.float64)
    xd, yd = d[:, 0::3], d[:, 1::3]  # (D, K)
    for j, gt in enumerate(gts):
        g = np.asarray(gt['keypoints'], dtype=np.float64)
        xg, yg, vg = g[0::3], g[1::3], g[2::3]
        k1 = int(np.count_nonzero(vg > 0))
        if k1 > 0:
            dx = xd - xg[None]
            dy = yd - yg[None]
        else:
            bb = gt['bbox']
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            dx = np.maximum(0, x0 - xd) + np.maximum(0, xd - x1)
            dy = np.maximum(0, y0 - yd) + np.maximum(0, yd - y1)
        e = (dx ** 2 + dy ** 2) / var[None] / (gt['area'] + np.spacing(1)) / 2
        if k1 > 0:
            e = e[:, vg > 0]
        ious[:, j] = np.exp(-e).sum(axis=1) / e.shape[1]
    return ious


def ann_to_rle(ann, h, w):
    """Annotation segmentation (polygons / uncompressed / compressed RLE)
    -> native RLE (parity: pycocotools annToRLE)."""
    from kgdet_tpu_torch.native import RLE
    seg = ann['segmentation']
    if isinstance(seg, list):
        rle = None
        for poly in seg:
            r = RLE.from_poly(poly, h, w)
            rle = r if rle is None else rle.merge(r)
        return rle
    counts = seg['counts']
    if isinstance(counts, list):
        return RLE(seg['size'][0], seg['size'][1], counts)
    return RLE.from_string(counts, seg['size'][0], seg['size'][1])


class CocoEvaluator:
    """Greedy-matching COCO evaluator over a GT and a DT CocoIndex."""

    def __init__(self, coco_gt, coco_dt, iou_type='bbox', kpt_sigmas=None):
        self.gt = coco_gt
        self.dt = coco_dt
        self.params = EvalParams(iou_type, kpt_sigmas)
        self.params.img_ids = sorted(coco_gt.imgs.keys())
        self.params.cat_ids = sorted(coco_gt.cats.keys())
        self.eval_imgs = {}
        self.eval = None
        self.stats = None

    # ---------------------------------------------------------------- prepare
    def _gather(self, index, img_id, cat_id):
        return [a for a in index.anns_for_img(img_id)
                if a['category_id'] == cat_id]

    def _prep_gt(self, anns):
        for g in anns:
            ignore = g.get('ignore', 0) or g.get('iscrowd', 0)
            if self.params.iou_type == 'keypoints':
                ignore = ignore or (g.get('num_keypoints', 0) == 0)
            g['_ignore'] = int(bool(ignore))
        return anns

    # ------------------------------------------------------------------- ious
    def _compute_iou(self, img_id, cat_id):
        p = self.params
        gts = self._gather(self.gt, img_id, cat_id)
        dts = self._gather(self.dt, img_id, cat_id)
        if len(gts) == 0 or len(dts) == 0:
            return np.zeros((len(dts), len(gts)))
        order = np.argsort([-d['score'] for d in dts], kind='mergesort')
        dts = [dts[i] for i in order][:p.max_dets[-1]]
        if p.iou_type == 'bbox':
            d = [dt['bbox'] for dt in dts]
            g = [gt['bbox'] for gt in gts]
            crowd = [gt.get('iscrowd', 0) for gt in gts]
            return bbox_iou_xywh(d, g, crowd)
        if p.iou_type == 'segm':
            h = self.gt.imgs[img_id].get('height')
            w = self.gt.imgs[img_id].get('width')
            d = [ann_to_rle(dt, h, w) for dt in dts]
            g = [ann_to_rle(gt, h, w) for gt in gts]
            crowd = [bool(gt.get('iscrowd', 0)) for gt in gts]
            from kgdet_tpu_torch.native import mask_iou_matrix
            return mask_iou_matrix(d, g, crowd)
        return compute_oks(dts, gts, p.kpt_sigmas)

    # ---------------------------------------------------------------- per-img
    def _evaluate_img(self, img_id, cat_id, area_rng, max_det, ious):
        p = self.params
        gts = self._prep_gt(self._gather(self.gt, img_id, cat_id))
        dts = self._gather(self.dt, img_id, cat_id)
        if len(gts) == 0 and len(dts) == 0:
            return None
        for g in gts:
            out_of_range = g['area'] < area_rng[0] or g['area'] > area_rng[1]
            g['_ignore_rng'] = 1 if (g['_ignore'] or out_of_range) else 0
        # sort: non-ignored gts first (stable); dts by score desc
        g_order = np.argsort([g['_ignore_rng'] for g in gts], kind='mergesort')
        gts = [gts[i] for i in g_order]
        d_order = np.argsort([-d['score'] for d in dts], kind='mergesort')
        dts = [dts[i] for i in d_order][:max_det]
        iscrowd = [int(g.get('iscrowd', 0)) for g in gts]
        ious_sub = (ious[:, g_order] if ious.size else ious)

        T = len(p.iou_thrs)
        G, D = len(gts), len(dts)
        gtm = np.zeros((T, G), dtype=np.int64)
        dtm = np.zeros((T, D), dtype=np.int64)
        gt_ig = np.asarray([g['_ignore_rng'] for g in gts])
        dt_ig = np.zeros((T, D))
        if ious_sub.size:
            for t, thr in enumerate(p.iou_thrs):
                for dind, d in enumerate(dts):
                    best_iou = min(thr, 1 - 1e-10)
                    m = -1
                    for gind in range(G):
                        # gt already matched (crowd gts can match many dts)
                        if gtm[t, gind] > 0 and not iscrowd[gind]:
                            continue
                        # gts are sorted unignored-first: once we have a match
                        # and reach the ignored tail, stop
                        if m > -1 and gt_ig[m] == 0 and gt_ig[gind] == 1:
                            break
                        if ious_sub[dind, gind] < best_iou:
                            continue
                        best_iou = ious_sub[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dt_ig[t, dind] = gt_ig[m]
                    dtm[t, dind] = gts[m]['id']
                    gtm[t, m] = d['id']
        # unmatched dts outside the area range are ignored
        a = np.asarray([d['area'] < area_rng[0] or d['area'] > area_rng[1]
                        for d in dts]).reshape(1, -1)
        dt_ig = np.logical_or(dt_ig, np.logical_and(dtm == 0,
                                                    np.repeat(a, T, axis=0)))
        return {
            'dt_scores': np.asarray([d['score'] for d in dts]),
            'dt_matches': dtm,
            'dt_ignore': dt_ig,
            'gt_ignore': gt_ig,
            'num_gt': int(np.count_nonzero(gt_ig == 0)),
        }

    # --------------------------------------------------------------- evaluate
    def evaluate(self):
        p = self.params
        for cat_id in p.cat_ids:
            for img_id in p.img_ids:
                ious = self._compute_iou(img_id, cat_id)
                for a, area_rng in enumerate(p.area_rng):
                    self.eval_imgs[(img_id, cat_id, a)] = self._evaluate_img(
                        img_id, cat_id, area_rng, p.max_dets[-1], ious)

    # ------------------------------------------------------------- accumulate
    def accumulate(self):
        p = self.params
        T, R = len(p.iou_thrs), len(p.rec_thrs)
        K, A, M = len(p.cat_ids), len(p.area_rng), len(p.max_dets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))
        for k, cat_id in enumerate(p.cat_ids):
            for a in range(A):
                entries = [self.eval_imgs.get((img_id, cat_id, a))
                           for img_id in p.img_ids]
                entries = [e for e in entries if e is not None]
                if not entries:
                    continue
                for m, max_det in enumerate(p.max_dets):
                    dt_scores = np.concatenate(
                        [e['dt_scores'][:max_det] for e in entries])
                    order = np.argsort(-dt_scores, kind='mergesort')
                    dt_scores_sorted = dt_scores[order]
                    dtm = np.concatenate(
                        [e['dt_matches'][:, :max_det] for e in entries],
                        axis=1)[:, order]
                    dt_ig = np.concatenate(
                        [e['dt_ignore'][:, :max_det] for e in entries],
                        axis=1)[:, order]
                    npig = sum(e['num_gt'] for e in entries)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dt_ig))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dt_ig))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp, fp = tp_sum[t], fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / np.maximum(fp + tp, np.spacing(1))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        # make precision monotonically decreasing
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds = np.searchsorted(rc, p.rec_thrs, side='left')
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        for ri, pi in enumerate(inds):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dt_scores_sorted[pi]
                        precision[:, :, k, a, m][t] = q
                        scores[:, :, k, a, m][t] = ss
        self.eval = {
            'precision': precision,
            'recall': recall,
            'scores': scores,
        }

    # -------------------------------------------------------------- summarize
    def _summarize(self, ap, iou_thr=None, area='all', max_det=100):
        p = self.params
        aind = p.area_lbl.index(area)
        mind = p.max_dets.index(max_det)
        if ap:
            s = self.eval['precision']
            if iou_thr is not None:
                s = s[np.where(np.abs(p.iou_thrs - iou_thr) < 1e-6)[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval['recall']
            if iou_thr is not None:
                s = s[np.where(np.abs(p.iou_thrs - iou_thr) < 1e-6)[0]]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self, verbose=True):
        p = self.params
        if p.iou_type in ('bbox', 'segm'):
            names = ['AP', 'AP50', 'AP75', 'APs', 'APm', 'APl',
                     'AR1', 'AR10', 'AR100', 'ARs', 'ARm', 'ARl']
            md = p.max_dets
            vals = [
                self._summarize(1, max_det=md[-1]),
                self._summarize(1, iou_thr=0.5, max_det=md[-1]),
                self._summarize(1, iou_thr=0.75, max_det=md[-1]),
                self._summarize(1, area='small', max_det=md[-1]),
                self._summarize(1, area='medium', max_det=md[-1]),
                self._summarize(1, area='large', max_det=md[-1]),
                self._summarize(0, max_det=md[0]),
                self._summarize(0, max_det=md[1]),
                self._summarize(0, max_det=md[2]),
                self._summarize(0, area='small', max_det=md[-1]),
                self._summarize(0, area='medium', max_det=md[-1]),
                self._summarize(0, area='large', max_det=md[-1]),
            ]
        else:
            names = ['AP', 'AP50', 'AP75', 'APm', 'APl',
                     'AR', 'AR50', 'AR75', 'ARm', 'ARl']
            vals = [
                self._summarize(1, max_det=20),
                self._summarize(1, iou_thr=0.5, max_det=20),
                self._summarize(1, iou_thr=0.75, max_det=20),
                self._summarize(1, area='medium', max_det=20),
                self._summarize(1, area='large', max_det=20),
                self._summarize(0, max_det=20),
                self._summarize(0, iou_thr=0.5, max_det=20),
                self._summarize(0, iou_thr=0.75, max_det=20),
                self._summarize(0, area='medium', max_det=20),
                self._summarize(0, area='large', max_det=20),
            ]
        self.stats = dict(zip(names, vals))
        if verbose:
            for n, v in self.stats.items():
                print(f'  {p.iou_type:9s} {n:6s} = {v:.4f}')
        return self.stats


def evaluate_json(gt, results, iou_types=('bbox', 'keypoints'), verbose=True):
    """One-call evaluation: GT index/path + result list/path -> stats dict."""
    from kgdet_tpu_torch.eval.coco import CocoIndex
    if not isinstance(gt, CocoIndex):
        gt = CocoIndex(gt)
    out = {}
    for iou_type in iou_types:
        res = results[iou_type] if isinstance(results, dict) else results
        dt = gt.load_results(res)
        ev = CocoEvaluator(gt, dt, iou_type)
        ev.evaluate()
        ev.accumulate()
        out[iou_type] = ev.summarize(verbose=verbose)
    return out
