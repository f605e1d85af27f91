"""Detection evaluation metrics (counterpart of ``mxnet_tpu/metric_det.py``;
ref ecosystem: gluoncv.utils.metrics.
voc_detection.VOC07MApMetric / VOCMApMetric — the evaluation half of the
SSD / Faster-RCNN driver configs; upstream MXNet ships the models, the
GluonCV side ships the mAP scoring).

Host-side numpy (evaluation is not a jit surface): accumulate per-image
detections + ground truths, then per-class AP by ranked precision/recall
with greedy IoU matching — VOC07's 11-point interpolation or the
all-points (area-under-PR) integral.
"""
from __future__ import annotations

import numpy as np

from .metric import EvalMetric, register

__all__ = ["VOCMApMetric", "VOC07MApMetric"]


def _iou_matrix(boxes_a, boxes_b):
    """IoU between (N,4) and (M,4) corner boxes."""
    if boxes_a.size == 0 or boxes_b.size == 0:
        return np.zeros((boxes_a.shape[0], boxes_b.shape[0]))
    tl = np.maximum(boxes_a[:, None, :2], boxes_b[None, :, :2])
    br = np.minimum(boxes_a[:, None, 2:], boxes_b[None, :, 2:])
    wh = np.clip(br - tl, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = np.prod(boxes_a[:, 2:] - boxes_a[:, :2], axis=1)
    area_b = np.prod(boxes_b[:, 2:] - boxes_b[:, :2], axis=1)
    union = area_a[:, None] + area_b[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-12), 0.0)


@register
class VOCMApMetric(EvalMetric):
    """Pascal-VOC mean average precision.

    ``update(labels, preds)`` per batch:
      labels: (B, M, 5+) ``[cls, x0, y0, x1, y1, (difficult)]`` rows,
        cls < 0 padding;
      preds:  (B, N, 6) ``[cls, score, x0, y0, x1, y1]`` rows, cls < 0
        padding — the layout SSD/Faster-RCNN inference emits.
    """

    def __init__(self, iou_thresh=0.5, class_names=None,
                 name="mAP", use_07_metric=False):
        # scalar -> VOC protocol; a LIST of thresholds averages AP over
        # them (pass np.arange(0.5, 1.0, 0.05) for the COCO-style
        # mAP@[.5:.95] headline number)
        if isinstance(iou_thresh, (list, tuple, np.ndarray)):
            # dedupe (order-preserving): a repeated threshold would
            # append to the same (thr, class) record list twice
            self._ious = list(dict.fromkeys(float(t) for t in iou_thresh))
        else:
            self._ious = [float(iou_thresh)]
        self._use07 = use_07_metric
        self._class_names = list(class_names) if class_names else None
        super().__init__(name)

    def reset(self):
        # per (iou_thresh, class): list of (score, tp); npos per class
        self._records = {}
        self._npos = {}
        self.num_inst = 0
        self.sum_metric = 0.0

    def update(self, labels, preds):
        from .metric import _as_list, _to_numpy
        for label, pred in zip(_as_list(labels), _as_list(preds)):
            label = _to_numpy(label)
            pred = _to_numpy(pred)
            if label.ndim == 2:
                label = label[None]
            if pred.ndim == 2:
                pred = pred[None]
            for lb, pd in zip(label, pred):
                self._update_one(lb, pd)

    def _update_one(self, label, pred):
        label = label[label[:, 0] >= 0]
        pred = pred[pred[:, 0] >= 0]
        difficult = label[:, 5].astype(bool) if label.shape[1] > 5 \
            else np.zeros(label.shape[0], bool)
        classes = set(label[:, 0].astype(int)) | \
            set(pred[:, 0].astype(int))
        for c in classes:
            gt = label[label[:, 0].astype(int) == c]
            gt_diff = difficult[label[:, 0].astype(int) == c]
            dt = pred[pred[:, 0].astype(int) == c]
            self._npos[c] = self._npos.get(c, 0) + int((~gt_diff).sum())
            order = np.argsort(-dt[:, 1]) if dt.shape[0] else []
            dt = dt[order] if dt.shape[0] else dt
            iou = _iou_matrix(dt[:, 2:6], gt[:, 1:5]) if dt.shape[0] \
                else None
            # threshold-independent best-match per detection, hoisted
            # out of the ladder loop
            jbest = iou.argmax(axis=1) if iou is not None and gt.shape[0] \
                else None
            for thr in self._ious:
                recs = self._records.setdefault((thr, c), [])
                if dt.shape[0] == 0:
                    continue
                taken = np.zeros(gt.shape[0], bool)
                for i in range(dt.shape[0]):
                    if gt.shape[0] == 0:
                        recs.append((float(dt[i, 1]), 0))
                        continue
                    j = int(jbest[i])
                    if iou[i, j] >= thr and gt_diff[j]:
                        # difficult GT: every matching detection is
                        # ignored (neither TP nor FP, never "taken" —
                        # VOC devkit / gluoncv protocol)
                        continue
                    if iou[i, j] >= thr and not taken[j]:
                        taken[j] = True
                        recs.append((float(dt[i, 1]), 1))
                    else:
                        recs.append((float(dt[i, 1]), 0))

    def _average_precision(self, rec, prec):
        if self._use07:
            ap = 0.0
            for t in np.arange(0.0, 1.01, 0.1):     # 11-point VOC07
                p = prec[rec >= t].max() if (rec >= t).any() else 0.0
                ap += p / 11.0
            return ap
        # all-points: area under the monotone precision envelope
        mrec = np.concatenate([[0.0], rec, [1.0]])
        mpre = np.concatenate([[0.0], prec, [0.0]])
        for i in range(mpre.size - 2, -1, -1):
            mpre[i] = max(mpre[i], mpre[i + 1])
        idx = np.where(mrec[1:] != mrec[:-1])[0]
        return float(((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]).sum())

    def get(self):
        aps = []
        names = []
        # report every configured class (gluoncv parity): names absent
        # from all updates still get a row (NaN — undefined AP)
        all_classes = set(self._npos)
        if self._class_names:
            all_classes |= set(range(len(self._class_names)))
        for c in sorted(all_classes):
            npos = self._npos.get(c, 0)
            if npos == 0:
                # prediction-only / all-difficult class: AP undefined —
                # excluded from the mean (gluoncv nanmean semantics)
                if self._class_names:
                    aps.append(float("nan"))
                    names.append(self._cname(c))
                continue
            per_thr = []
            for thr in self._ious:
                recs = self._records.get((thr, c), [])
                if not recs:
                    per_thr.append(0.0)
                    continue
                recs = sorted(recs, key=lambda r: -r[0])
                tp = np.array([r[1] for r in recs], np.float64)
                fp = 1.0 - tp
                tp_c = np.cumsum(tp)
                fp_c = np.cumsum(fp)
                rec = tp_c / npos
                prec = tp_c / np.maximum(tp_c + fp_c, 1e-12)
                per_thr.append(self._average_precision(rec, prec))
            aps.append(float(np.mean(per_thr)))
            names.append(self._cname(c))
        defined = [a for a in aps if not np.isnan(a)]
        mean_ap = float(np.mean(defined)) if defined else float("nan")
        if self._class_names:
            return (names + [self.name],
                    [float(a) for a in aps] + [mean_ap])
        return self.name, mean_ap

    def _cname(self, c):
        if self._class_names and 0 <= c < len(self._class_names):
            return self._class_names[c]
        return f"class{c}"


@register
class VOC07MApMetric(VOCMApMetric):
    """VOC07 11-point interpolated mAP (ref ecosystem: gluoncv
    VOC07MApMetric — the SSD paper's protocol)."""

    def __init__(self, iou_thresh=0.5, class_names=None, name="mAP"):
        super().__init__(iou_thresh=iou_thresh, class_names=class_names,
                         name=name, use_07_metric=True)
