"""The entry of a configuration that runs ``tpumcia_torch.run_pipeline``: the
intensity + GLCM feature matrix, a logistic head and both permutation
sweeps, judged against ``reference.py`` by ``correct.py``'s six numbers.

A configuration without an ``entry`` key runs this one.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import tpumcia_torch as tt
from perfbench import correct, counts, reference, trace

REFERENCE = "reference"  # perfbench/reference.py: the plain reference
NUMBERS = correct.NUMBERS
CONTROLS = ("bf16", "tf32_head")  # reference.analyze's controls
readings = correct.readings


def call(inputs: dict, pipeline: dict, device: torch.device, timer=None):
    """One ``run_pipeline`` call over the collection (not synchronised)."""
    kw = {} if device.type == "cuda" else {"device": "cpu"}
    return tt.run_pipeline(inputs["images"], inputs["labels"], mask=inputs["mask"],
                           groups=inputs["groups"], config=tt.PipelineConfig.from_dict(pipeline),
                           timer=timer, **kw)


def settings(pipeline: dict) -> dict:
    """What the reference takes of the configuration, as its files state it
    (every key the reference reads is written out there)."""
    glcm = pipeline["features"]["glcm"]
    angle, dist = glcm["angle"], glcm["distance"]
    return {
        "levels": glcm["levels"],
        "offset": (int(round(math.sin(angle) * dist)), int(round(math.cos(angle) * dist))),
        "split": pipeline["split"], "head": pipeline["head"],
        "importance": pipeline["importance"], "synth": pipeline["synth"],
        "batch_size": pipeline["batch_size"],
    }


def program_outputs(result) -> dict:
    """What the judged call produced, in the reference's terms: the host
    feature matrix, the split, the head's class probabilities on the test
    rows (its scaler and weights applied to the matrix it was fitted on) and
    both sweeps' mean drops."""
    fm = result.features
    X = fm.device_values
    if X is None:
        X = torch.from_numpy(np.nan_to_num(np.asarray(fm.values, dtype=np.float32)))
    te = torch.as_tensor(result.test_idx)
    with torch.no_grad():
        proba = result.head.predict_proba(X[te.to(X.device)])
    return {
        "features": np.asarray(fm.values, dtype=np.float64),
        "train_idx": np.asarray(result.train_idx), "test_idx": np.asarray(result.test_idx),
        "proba": proba.double().cpu().numpy(),
        "channel": np.asarray(result.channel_result.total, dtype=np.float64),
        "column": np.asarray(result.feature_result.feature_importances, dtype=np.float64),
    }


def reference_outputs(spec: dict, inputs: dict, device, *, control=None) -> dict:
    """The plain reference over the same inputs (``control``: one of
    :data:`CONTROLS`, as ``reference.analyze`` takes it)."""
    st = settings(spec["pipeline"])
    images = inputs["images"]
    if st["synth"]["noise_channels"] > 0:
        levels = reference.noise_stack(images, num_noise=st["synth"]["noise_channels"],
                                       var=st["synth"]["var"], seed=st["synth"]["seed"],
                                       batch=st["batch_size"])
    else:
        levels = images.permute(0, 3, 1, 2)
    return reference.analyze(levels, inputs["mask"], inputs["labels"], inputs["groups"],
                             pipeline=st, control=control)


def shape(spec: dict, result, labels) -> dict:
    """The cell's shapes, for the frozen counts."""
    d, p = spec["data"], settings(spec["pipeline"])
    channels = d.get("channels", 1 + p["synth"]["noise_channels"])
    return {
        "objects": d["objects"], "batch": p["batch_size"], "channels": channels, "hw": d["hw"],
        "levels": p["levels"], "mask_channels": d["mask_channels"],
        "need_diff": spec["traffic"]["glcm_need_diff"], "features": 23 * channels,
        "n_train": len(result.train_idx), "n_test": len(result.test_idx),
        "classes": len(np.unique(labels[result.train_idx])),
        "repeats": p["importance"]["n_repeats"], "steps": p["head"]["num_steps"],
        "head_kind": p["head"]["kind"],
    }


def expected_kernels(spec: dict, calls: int) -> dict:
    """One GLCM statistics launch a batch of the collection, each call."""
    n = spec["data"]["objects"]
    return {trace.GLCM_KERNEL: calls * counts.glcm_launches(n, spec["pipeline"]["batch_size"])}
