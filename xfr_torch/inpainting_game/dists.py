"""Mate/non-mate distance sampling over IJB-C (port of
xfr_tpu/inpainting_game/dists.py; reference:
python/xfr/inpainting_game/net_mate_nonmate_dists.py:55-144).

Samples subject pairs + 64 nonmates per subject, embeds them in one batched
call, and collects the L2 distance distributions used for match-threshold
calibration.
"""

from __future__ import annotations

import os
import random
import timeit

import numpy as np


def load_ijbc_metadata(ijbc_path):
    import pandas as pd

    md = pd.read_csv(os.path.join(ijbc_path, "protocols",
                                  "ijbc_metadata.csv"))
    md = md.loc[np.invert(np.isnan(md["SUBJECT_ID"]))]
    md["Filename"] = [os.path.join(ijbc_path, fn) for fn in md["FILENAME"]]
    md = md.rename(columns={
        "SUBJECT_ID": "SubjectID", "FACE_X": "XMin", "FACE_Y": "YMin",
        "FACE_WIDTH": "Width", "FACE_HEIGHT": "Height"})
    for col in ("XMin", "YMin", "Width", "Height"):
        md = md.loc[np.invert(np.isnan(md[col].values))]
    return md.loc[md["Width"] > 100]


def calc_mate_nonmate_dists(net, num_subjects, seed, output_dir, ijbc_path,
                            num_nonmates=64):
    """Returns (mate_dists, nonmate_dists) arrays."""
    import pandas as pd

    ijbc_metadata = load_ijbc_metadata(ijbc_path)
    os.makedirs(output_dir, exist_ok=True)

    mate_dists, nonmate_dists = [], []
    random.seed(seed)
    groups = ijbc_metadata.groupby(["SubjectID"])
    selected = random.sample(range(len(groups)), num_subjects)
    sampled = [grp for i, grp in enumerate(groups) if i in selected]
    seed += 1
    total, ndur = 0.0, 0
    for group_num, (sid, subj_grp) in enumerate(sampled):
        if len(subj_grp) < 2:
            continue
        t0 = timeit.default_timer()
        chosen_subjs = subj_grp.sample(2, random_state=seed)
        seed += 1
        chosen_others = ijbc_metadata.loc[
            ijbc_metadata["SubjectID"] != sid].sample(
            num_nonmates, random_state=seed)
        chosen = pd.concat([chosen_subjs, chosen_others])
        embeddings = net.embeddings(chosen, norm=True)
        mates = embeddings[:len(chosen_subjs)][:, np.newaxis, :]
        others = embeddings[np.newaxis, 2:, :]
        mate_dists.append(np.linalg.norm(mates[0] - mates[1]))
        nonmate_dists.append(np.linalg.norm(mates - others, axis=2))
        seed += 1
        dur = timeit.default_timer() - t0
        total += dur
        ndur += 1
        print("subject group %d finished in %0.1fs (avg %0.1f)"
              % (group_num, dur, total / ndur))
    return np.stack(mate_dists), np.stack(nonmate_dists).reshape(-1)


def fit_match_threshold(mate_dists, nonmate_dists, target_fpr=1e-4):
    """ROC threshold at FPR~=target + Platt scaling
    (reference: eval/calculate_net_match_threshold.py:52-107).

    Platt scaling: logistic regression without intercept on dist - thresh,
    Prob(nonmate) = 1 / (1 + exp(-alpha * (dist - thresh))).
    """
    thresholds = np.concatenate([mate_dists, nonmate_dists])
    thresholds.sort()
    thresholds = np.insert(thresholds, 0, 0)
    thresholds = np.unique(np.around(thresholds, 4))

    fp = np.sum(nonmate_dists[:, None] <= thresholds[None, :], axis=0)
    fpr = fp.astype(np.float64) / len(nonmate_dists)
    thresh = thresholds[np.argmin(abs(fpr - target_fpr))]

    tp = np.sum(mate_dists[:, None] <= thresholds[None, :], axis=0)
    tpr = tp.astype(np.float64) / len(mate_dists)

    dists = np.concatenate([mate_dists, nonmate_dists]) - thresh
    y = np.ones(dists.shape)
    y[:len(mate_dists)] = 0
    alpha = _logreg_no_intercept(dists, y)
    return float(thresh), float(alpha), fpr, tpr


def _logreg_no_intercept(x, y, iters=100):
    """1-D logistic regression without intercept (Newton).  Equivalent of
    sklearn LogisticRegression(fit_intercept=False) with its default L2
    regularization (C=1)."""
    try:
        from sklearn.linear_model import LogisticRegression

        lr = LogisticRegression(fit_intercept=False)
        lr.fit(x[:, None], y.astype(int))
        return float(lr.coef_[0, 0])
    except ImportError:
        pass
    w = 0.0
    lam = 1.0  # sklearn default C=1 -> lambda=1
    for _ in range(iters):
        p = 1.0 / (1.0 + np.exp(-w * x))
        grad = np.sum((p - y) * x) + lam * w
        hess = np.sum(p * (1 - p) * x * x) + lam
        step = grad / max(hess, 1e-12)
        w -= step
        if abs(step) < 1e-12:
            break
    return float(w)
