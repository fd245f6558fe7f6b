"""Self-supervised pseudo-labels: per-point dynamic masks, cluster ids and
translation priors (port of ``himo_tpu/training/ssl_labels.py``).

The numpy code is the reference's, call for call, with three host
libraries replaced, since the card's host has none of them:

- KD-tree queries go through scipy's ``cKDTree`` (the reference takes its
  native tree when built and falls back to ``cKDTree``);
- sklearn's ``HDBSCAN`` and ``DBSCAN(min_samples=1)`` are
  :mod:`himo_tpu_torch.training.clustering`, which returns the same labels;
  the reference's DBSCAN fallback for sklearn < 1.3 is not ported;
- scene files are read with :mod:`himo_tpu_torch.data.h5` and each labelled
  scene is written whole (the reference appends with h5py's ``"a"`` mode):
  every dataset the file held is kept as it was, and the four ``ssl_*``
  datasets are added or replaced with the reference's dtypes.

What it computes:

- dynamic evidence, NN residual (``method=nn``): after ego-compensation a
  static point finds a near neighbor in the next sweep; points whose NN
  distance exceeds ``dynamic_threshold`` are dynamic;
- dynamic evidence, occupancy change (``method=dufo``): DUFOMap-style
  ray-carved void voxels with a per-sweep protection margin, fused with the
  NN candidates by cluster-level voting;
- clusters: HDBSCAN over the dynamic points, ids compacted to
  ``1..num_clusters``, 0 = background;
- translation priors: per-cluster deltas from ``models/icp_flow``'s host
  matcher, spread to each cluster's points.

Labels are written into the .h5 frame groups as ``ssl_dynamic`` (bool),
``ssl_cluster`` (uint16), ``ssl_prior`` (float32 (N, 3)) and
``ssl_prior_valid`` (bool).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np

from himo_tpu_torch.data import h5
from himo_tpu_torch.data.dataset import SceneFlowDataset

from himo_tpu_torch.core.transforms import rigid_flow
from himo_tpu_torch.training.clustering import connected_components, hdbscan


def nn_residual_distances(pc0_comp: np.ndarray, pc1: np.ndarray) -> np.ndarray:
    """Per-point NN distance into the next sweep (scipy's KD-tree)."""
    if len(pc1) == 0:
        return np.full(len(pc0_comp), np.inf, np.float32)
    from scipy.spatial import cKDTree

    d, _ = cKDTree(pc1[:, :3]).query(pc0_comp[:, :3], k=1)
    return np.asarray(d, np.float32)


def adaptive_dynamic_threshold(
    d: np.ndarray, base: float = 0.18, factor: float = 2.5
) -> float:
    """Density-aware dynamic threshold.

    A fixed 0.18 m residual test silently breaks on sparse/subsampled clouds:
    static points' NN spacing alone exceeds it and half the background gets
    flagged dynamic (measured on the 8192-point subsampled benchmark:
    ~2500 background false positives, object clusters merged with noise).
    Static points dominate every automotive frame, so ``factor`` x the median
    residual separates movers from sampling noise at any density.
    ``factor`` trades recall on smeared movers (whose self-overlap hides
    half the body just under the cut) against static false positives; 2.5
    keeps a 15 m/s object's body majority-flagged while the 5-NN coherence
    prune in :func:`dynamic_mask_from_nn` absorbs the extra scatter."""
    d = d[np.isfinite(d)]
    if len(d) == 0:
        return base
    return float(max(base, factor * np.median(d)))


def dynamic_mask_from_nn(
    pc0_comp: np.ndarray,
    pc1: np.ndarray,
    threshold: float = 0.18,
    adaptive: bool = True,
    coherent: bool = True,
    local_floor: float = 0.0,
) -> np.ndarray:
    """Points of pc0_comp with no near neighbor in pc1.

    ``adaptive=True`` raises the threshold on sparse clouds (see
    :func:`adaptive_dynamic_threshold`); ``threshold`` is the dense-cloud
    floor either way.

    ``local_floor`` raises each point's threshold to ``local_floor x`` its
    OWN-cloud nearest-neighbor spacing. MEASURED-REJECTED as a default
    (keep 0): per-point residual/spacing ratios of a re-sampled STATIC
    sparse surface (p50 ~1.0) and a fast smeared mover's interior
    (p50 ~1.7) overlap too much — any factor that silences resampling
    noise also drops a third of true mover points
    (tests/test_matcher_stress.py measurements). The spurious-static-prior
    failure it targeted is handled at the CLUSTER level instead: the
    zero-motion null test in models/icp_flow.motion_beats_null.

    ``coherent=True`` additionally requires a candidate's pc0 neighborhood
    to agree (majority of its 5 nearest points also over threshold).
    Movers move together, so true dynamic points sit in coherent blobs; on
    subsampled clouds the raw test is dominated by SCATTERED false
    positives — static points whose pc1 counterpart was dropped by the
    subsample (measured: 520 of 577 flags were isolated statics at 2048
    pts/cloud, and every density-adaptive clusterer happily turns such
    scatter into junk clusters that then poison the prior matching)."""
    d = nn_residual_distances(pc0_comp, pc1)
    if adaptive:
        threshold = adaptive_dynamic_threshold(d, base=threshold)
    thr = np.full(len(d), threshold, np.float32)
    own_idx = None
    if (coherent or local_floor > 0) and len(pc0_comp) > 6:
        from scipy.spatial import cKDTree

        own_d, own_idx = cKDTree(pc0_comp[:, :3]).query(pc0_comp[:, :3], k=6)
        if local_floor > 0:
            thr = np.maximum(thr, local_floor * np.asarray(own_d)[:, 1])
    dyn = d > thr
    if coherent and dyn.any() and own_idx is not None:
        # Coherence prune over the 5-NN graph. Columns 1..5 are the 5
        # nearest OTHER points (column 0 is self): a flag with <= 1
        # dynamic neighbor is isolated scatter. (A hole-FILL pass was
        # tried for the interleaved under-threshold pattern of smeared
        # objects and measured net-negative: it bled object priors onto
        # touching structures; the lower adaptive factor recovers that
        # recall instead.)
        votes = dyn[np.asarray(own_idx)[:, 1:]].sum(1)
        return dyn & (votes >= 2)
    return dyn


def _merge_surface_fragments(
    pts: np.ndarray, labels: np.ndarray, eps_eff: float
) -> np.ndarray:
    """Union HDBSCAN clusters lying in one connectivity component.

    HDBSCAN splits HOLLOW surfaces at their creases — a box shell (and a
    real vehicle's one-sided LiDAR return) comes back as 4-5 face
    fragments (measured), and a per-face rigid ICP then slides along each
    plane's unconstrained direction. DBSCAN's absolute-eps connectivity
    kept such shells whole, so: compute single-linkage components over ALL
    points (noise points bridge the creases) at the adaptive-DBSCAN
    ``eps_eff`` and union the clusters that share a component. This can
    only ADD unions on top of HDBSCAN's density separation — fragments it
    keeps apart are exactly the pairs DBSCAN would have merged anyway, and
    the split-recovery matcher handles those."""
    ids = np.unique(labels[labels >= 0])
    if len(ids) < 2:
        return labels
    comp = connected_components(pts, eps_eff)
    out = labels.copy()
    # Map each component to the first cluster id seen in it; relabel the
    # rest of that component's clusters to it.
    comp_to_cid = {}
    for c in ids:
        comps = np.unique(comp[labels == c])
        target = None
        for k in comps:
            if int(k) in comp_to_cid:
                target = comp_to_cid[int(k)]
                break
        if target is None:
            target = int(c)
        for k in comps:
            comp_to_cid[int(k)] = target
        if target != int(c):
            out[labels == c] = target
    return out


def _dbscan_adaptive(
    pts: np.ndarray,
    eps: float,
    min_samples: int,
    spacing_mult: float = 2.5,
    eps_cap: float = 1.6,
) -> np.ndarray:
    """Density-adaptive clustering of dynamic points: HDBSCAN
    (excess-of-mass selection), per-cluster density adaptation that one
    global eps cannot give (a fast object's rolling-shutter smear spreads
    it at 0.4-1.0 m spacing while dense slow movers in the same frame sit
    at ~0.3 m). Returns raw labels (-1 = noise), sklearn's numbering."""
    min_cluster_size = max(int(min_samples), 2)
    labels = hdbscan(pts, min_cluster_size)
    if labels.max(initial=-1) < 0 and len(pts) >= min_samples:
        # eom never selects the ROOT cluster: an input that is ONE
        # cluster (a lone dynamic object in the frame) comes back
        # all-noise. Retrying with allow_single_cluster only when the
        # first pass found nothing cannot disturb multi-cluster frames.
        labels = hdbscan(pts, min_cluster_size, allow_single_cluster=True)
    eps_eff = eps
    if len(pts) >= 4:
        spacing = float(
            np.median(nn_residual_distances(pts[0::2], pts[1::2]))
        )
        if np.isfinite(spacing):
            eps_eff = float(np.clip(spacing_mult * spacing, eps, eps_cap))
    return _merge_surface_fragments(pts, labels, eps_eff)


def cluster_dynamic_points(
    points: np.ndarray,
    dynamic: np.ndarray,
    eps: float = 0.6,
    min_samples: int = 8,
    max_clusters: int = 63,
) -> np.ndarray:
    """Density-adaptive cluster ids (1..max_clusters) for dynamic
    points, 0 elsewhere (see :func:`_dbscan_adaptive`)."""
    labels = np.zeros(len(points), dtype=np.uint16)
    idx = np.where(dynamic)[0]
    if len(idx) < min_samples:
        return labels
    raw = _dbscan_adaptive(points[idx, :3], eps, min_samples)
    # HDBSCAN keeps only each cluster's dense core and drops the outskirts
    # as noise (measured 27% of a gaussian blob); an object's membership
    # should cover its whole extent, so noise points are ABSORBED into the
    # cluster of their nearest clustered neighbor when that neighbor is
    # within 2x the local spacing implied by ``eps`` (stray scatter beyond
    # it stays noise).
    if (raw >= 0).any() and (raw < 0).any():
        from scipy.spatial import cKDTree

        cl_ix = np.flatnonzero(raw >= 0)
        no_ix = np.flatnonzero(raw < 0)
        dist, nn = cKDTree(points[idx[cl_ix], :3]).query(points[idx[no_ix], :3])
        take = dist <= 2.0 * eps
        raw[no_ix[take]] = raw[cl_ix[nn[take]]]
    # Compact to 1..max_clusters, largest clusters first.
    ids, counts = np.unique(raw[raw >= 0], return_counts=True)
    order = ids[np.argsort(-counts)][:max_clusters]
    remap = {int(cid): i + 1 for i, cid in enumerate(order)}
    labels[idx] = np.array([remap.get(int(c), 0) for c in raw], dtype=np.uint16)
    return labels


def complete_cluster_bodies(
    points: np.ndarray,
    labels: np.ndarray,
    eligible: np.ndarray,
    hops: int = 3,
    spacing_mult: float = 2.5,
    r_cap: float = 0.45,
) -> np.ndarray:
    """Absorb each cluster's UNDER-THRESHOLD interior into its membership.

    The dynamic mask is density-DEPENDENT in a way clustering must undo: a
    mover's self-overlap region (trailing body of sweep 1 coinciding with
    the leading body of sweep 0) has NN residuals that SHRINK as sampling
    densifies, so at production density most of the interior drops under
    the dynamic threshold (measured on the bucket-complete suite: 0.68-0.90
    of object points flagged at 18.4k pts/frame vs 0.48-0.78 at 65.4k).
    Matching fragment clusters then fails asymmetrically: the truth's
    verification pays a coverage-mismatch penalty (unexplained interior in
    the two-sided residual) while smear-alias deltas — whose wrong de-smear
    STRETCHES the cloud over the window — pass (measured: scene_001 29.5
    m/s truth err 0.464 > tol 0.45, aliases at 1.66x/2.14x the true delta
    err ~0.36).

    Fix at the root: transitively absorb eligible unlabeled points within a
    per-cluster hop radius (``spacing_mult`` x the cluster's own median NN
    spacing, capped at ``r_cap`` so dense scenes cannot bridge across the
    inter-object gap) into the nearest cluster. ``eligible`` must exclude
    ground (the synthetic ground gap is ~1 x point spacing) and anything the
    caller wants barred. Labels are returned as a new array; ties go to the
    nearest labeled point's cluster. Bounded growth: ``hops`` x ``r_cap``
    from the dynamic seed."""
    from scipy.spatial import cKDTree

    out = np.asarray(labels).copy()
    if out.max(initial=0) == 0:
        return out
    # Per-cluster hop radius from the seed's own spacing.
    ids = np.unique(out[out > 0])
    r_of = np.zeros(int(out.max()) + 1, np.float32)
    from himo_tpu_torch.models.icp_flow import _cluster_spacing

    for cid in ids:
        sp = _cluster_spacing(points[out == cid, :3])
        r_of[cid] = float(np.clip(spacing_mult * (sp if np.isfinite(sp) else 0.2),
                                  0.15, r_cap))
    eligible = np.asarray(eligible, bool)
    for _ in range(hops):
        lab_ix = np.flatnonzero(out > 0)
        un_ix = np.flatnonzero(eligible & (out == 0))
        if len(un_ix) == 0 or len(lab_ix) == 0:
            break
        dist, nn = cKDTree(points[lab_ix, :3]).query(points[un_ix, :3])
        src = out[lab_ix[nn]]
        take = dist <= r_of[src]
        if not take.any():
            break
        out[un_ix[take]] = src[take]
    return out


def translation_priors(
    pc0_comp: np.ndarray,
    labels0: np.ndarray,
    xyz1: np.ndarray,
    dynamic1: np.ndarray,
    eps: float = 0.6,
    min_samples: int = 8,
    max_clusters: int = 63,
    match_gate: float = 6.0,
    min_norm: float = 0.0,
    dt0=None,
    dt1=None,
    period: float = 0.1,
    tracker=None,
    pose1=None,
    eligible0=None,
    eligible1=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-point translation priors for fast objects.

    Clusters pc1's dynamic points, greedily matches cluster centroids across
    the sweeps (1-1, gated at ``match_gate`` m = ~45 m/s at 10 Hz), and
    spreads each matched cluster's centroid delta to its pc0 points. The
    resulting prior reaches objects whose 2.5-3.4 m/frame motion lies beyond
    any chamfer truncation radius — the supervision signal HiMo's high-speed
    regime needs (cf. the worst-case sweep-travel box growth of HiMo's
    ``dataprocess/extract_sca.py:110-114``).

    Per-point sweep times (``dt0``/``dt1`` = the schema's ``lidar_dt``) let
    the matcher de-smear rolling-shutter smears with each candidate delta,
    and pc0 clusters the 1-1 matching leaves unmatched are recovered against
    pc1's raw dynamic points (merged/unclustered targets) — see
    models/icp_flow.match_cluster_translations.

    ``min_norm`` drops matches whose delta is below it (estimator seeding
    only needs priors where plain chamfer cannot reach; small spurious
    deltas on static structures would otherwise have to be unlearned).

    ``tracker`` (a models/icp_flow.ClusterTracker, with ``pose1`` = this
    pair's world<-ego1 pose) adds cross-frame velocity continuity: tracked
    deltas enter the matcher as preferred candidates and this frame's
    accepted matches update the tracks. Callers keep one tracker per scene
    and feed frames in order.

    ``eligible0``/``eligible1`` (bool masks over pc0/pc1; pass the
    non-ground masks) enable the density-invariance fixes: at production
    density the dynamic mask misses a mover's self-overlap interior (NN
    residuals shrink as sampling densifies), and fragment clusters verify
    smear aliases over the truth. Two asymmetric mechanisms, split by a
    measured A/B on the 65k bucket-complete suite:

    - ``eligible1`` completes the pc1 EVIDENCE side
      (:func:`complete_cluster_bodies` on labels1 + the recovery pool):
      the truth's two-sided verification needs the interior pc1 points in
      its bbox window and the histogram needs their same-surface votes
      (scene_001 29.5 m/s: truth err 0.464 > tol while 2.14x aliases
      passed; with pc1 completion the truth wins, err 1.96 -> 0.06).
    - ``eligible0`` does NOT complete the pc0 CLAIM side — completing
      claims was measured WORSE (a merged 3-object cluster grew 12%
      bridged background, and split recovery misassigned a 25 m/s member
      at 0.98 m err). Instead it gates the PAINT expansion below: accepted
      claims spread to hop-connected unlabeled points whose motion
      residual under the claim's delta is explained by the completed pc1
      evidence — the under-threshold interior gets its prior without ever
      entering the matcher.

    The stored cluster labels the caller keeps are unchanged.

    Returns ((N, 3) float32 prior flow, (N,) bool prior validity)."""
    from himo_tpu_torch.models.icp_flow import match_cluster_translations

    labels1 = cluster_dynamic_points(
        xyz1, dynamic1, eps=eps, min_samples=min_samples, max_clusters=max_clusters
    )
    pool1 = np.asarray(dynamic1, bool)
    if eligible1 is not None:
        labels1 = complete_cluster_bodies(xyz1, labels1, eligible1)
        pool1 = pool1 | (labels1 > 0)
    track_priors = None
    track_meas = None
    if tracker is not None and pose1 is not None:
        track_priors = tracker.predict(pose1)
        track_meas = tracker.predict_measured(pose1)
    measured = {}  # cluster i / (i, split k) -> pre-snap measured delta
    init_t, matched, splits = match_cluster_translations(
        pc0_comp, labels0, xyz1, labels1, max_clusters, match_gate,
        dt0=dt0, dt1=dt1, period=period, recover_dynamic1=pool1,
        recover_cand1=np.asarray(dynamic1, bool),
        return_splits=True, track_priors=track_priors,
        track_meas=track_meas, measured_out=measured,
        eligible0=eligible0,
    )
    prior = np.zeros((len(pc0_comp), 3), np.float32)
    prior_valid = np.zeros(len(pc0_comp), bool)
    assigned = []  # (centroid, delta) for the tracker update
    paint_jobs = []  # accepted (subset indices, delta) for paint expansion

    from himo_tpu_torch.models.icp_flow import motion_beats_null

    def null_verdict(delta, subset_ix, exclude):
        """Every emitted motion claim must beat the zero-motion null on its
        full local evidence (see motion_beats_null: spurious deltas from
        biased dynamic-mask shards of re-sampled sparse static structure
        verify within tolerance but lose to the null). ``'static'`` demotes
        the delta to 0 (a verified MATCH whose honest motion estimate is
        'did not move' — the tracker and prior supervise static instead of
        fabricated motion); ``'ambiguous'`` drops the claim entirely.

        CONFIRMED-track veto: a large object displacing less than its own
        length self-overlaps under the null (its faces slide along
        themselves; the trim drops the falsifying edge strip — measured: a
        6.5 m truck at 28 m/s demoted to static on the crossing stress
        scene). Velocity continuity is the disambiguating evidence, so a
        claim consistent with a CONFIRMED track skips the null. Fabricated
        motion cannot ride this veto: the tracker is updated with the
        POST-null deltas, so a demoted spurious match confirms a static
        track, never a moving one."""
        delta = np.asarray(delta, np.float32)
        if float(np.linalg.norm(delta)) < 1e-6:
            return "motion", delta
        # The null test targets TOLERANCE-SCALE fabrications: a spurious
        # delta fitted to a static surface's resample-noise shards can only
        # reach ~the verification tolerance (measured 0.5-0.6 m at 0.7 m
        # tol). Claims far beyond it carry structural evidence the
        # two-sided verification already vetted — and running the null on
        # them is actively unsafe: its evidence expansion can leak through
        # dense background (static points that align perfectly under zero)
        # and demote a whole scene's true fast movers (measured: every
        # 25-34 m/s object of a bucket-complete scene zeroed).
        from himo_tpu_torch.models.icp_flow import _cluster_spacing

        tol_claim = min(
            max(0.45, 1.75 * _cluster_spacing(pc0_comp[subset_ix])), 1.0
        )
        if float(np.linalg.norm(delta)) > 2.0 * tol_claim:
            # KNOWN ENVELOPE: on an ULTRA-sparse lone claim (~0.7 m point
            # spacing, tens of points) the two-sided verification is
            # toothless and a fabricated multi-meter delta can ride this
            # bypass (a lone 60-point static object once acquired a 3.55 m
            # prior). Gating the bypass on claim spacing was tried and
            # REVERTED: at 18k pts/frame real fast movers' claims are
            # sparse too, the null leaked through their landing zones, and
            # the zeroed frames confirmed STATIC tracks that locked the
            # objects at zero for the whole scene (16 of 156 fast instances
            # wrong, from 1). The null stays dense-claims-only.
            return "motion", delta
        # Measured-velocity continuity veto (slow movers): a SUB-tolerance
        # delta whose direction+magnitude agree with a measured-confirmed
        # track is physical motion noise can't fake (fabricated deltas have
        # random direction per frame) — skip the null, keep the motion.
        if track_meas:
            from himo_tpu_torch.models.icp_flow import measured_track_consistent

            cent_m = pc0_comp[subset_ix, :3].mean(0)
            if measured_track_consistent(delta, cent_m, track_meas):
                return "motion", delta
        if track_priors:
            cent = pc0_comp[subset_ix, :3].mean(0)
            for pos, td, conf in track_priors:
                td = np.asarray(td)
                # The track must itself be MOVING (> 1 m/frame): a confirmed
                # static track agrees with the null and must not shelter a
                # sub-tolerance claim from it (measured: a 0.59 m fabricated
                # delta riding a confirmed zero track through |td-d|<=0.6).
                if (
                    conf
                    and float(np.linalg.norm(td)) > 1.0
                    and float(np.linalg.norm(np.asarray(pos) - cent)) <= 3.0
                    and float(np.linalg.norm(td - delta)) <= 0.6
                ):
                    return "motion", delta
        v = motion_beats_null(
            pc0_comp[subset_ix], pc0_comp, xyz1, delta,
            dt0=None if dt0 is None else np.asarray(dt0)[subset_ix],
            dt0_full=dt0, dt1_full=dt1, period=period, exclude=exclude,
        )
        return v, (delta if v == "motion" else np.zeros(3, np.float32))

    for cid in range(1, int(labels0.max()) + 1):
        if cid - 1 >= max_clusters:
            continue
        m_ix = np.flatnonzero(labels0 == cid)
        # Evidence expansion must not bridge into OTHER objects: bar other
        # clusters' points (and, below, sibling split subsets).
        excl_other = (labels0 > 0) & (labels0 != cid)
        if cid - 1 in splits:
            # Split-recovered cluster (merged objects / clusterless target):
            # each verified delta covers only its inlier subset.
            for si, (delta, local_mask) in enumerate(splits[cid - 1]):
                excl = excl_other.copy()
                for sj, (_, other_mask) in enumerate(splits[cid - 1]):
                    if sj != si:
                        excl[m_ix[other_mask]] = True
                meas = measured.get((cid - 1, si), delta)
                verdict, delta = null_verdict(delta, m_ix[local_mask], excl)
                if verdict == "ambiguous":
                    continue
                assigned.append(
                    (pc0_comp[m_ix[local_mask], :3].mean(0), delta, meas)
                )
                if np.linalg.norm(delta) < min_norm:
                    continue
                prior[m_ix[local_mask]] = delta
                prior_valid[m_ix[local_mask]] = True
                paint_jobs.append((m_ix[local_mask], delta))
        elif matched[cid - 1]:
            meas = measured.get(cid - 1, init_t[cid - 1])
            verdict, delta = null_verdict(init_t[cid - 1], m_ix, excl_other)
            if verdict == "ambiguous":
                continue
            assigned.append((pc0_comp[m_ix, :3].mean(0), delta, meas))
            if np.linalg.norm(delta) < min_norm:
                continue
            prior[m_ix] = delta
            prior_valid[m_ix] = True
            paint_jobs.append((m_ix, delta))
    if tracker is not None and pose1 is not None:
        tracker.update(assigned, pose1)
    if eligible0 is not None and paint_jobs:
        _expand_painted_priors(
            prior, prior_valid, paint_jobs, pc0_comp, labels0,
            np.asarray(eligible0, bool), xyz1, pool1,
            dt0=dt0, dt1=dt1, period=period,
        )
    return prior, prior_valid


def _expand_painted_priors(
    prior, prior_valid, paint_jobs, pc0_comp, labels0, eligible0,
    xyz1, pool1, dt0=None, dt1=None, period=0.1,
):
    """Spread accepted motion claims to the under-threshold object interior.

    At production density a mover's self-overlap interior falls under the
    dynamic threshold (see :func:`complete_cluster_bodies`), so the claim
    subsets cover ~half the body (measured 0.47-0.54 at 65.4k pts/frame vs
    0.68-0.90 at 18.4k). Completing the pc0 clusters BEFORE matching was
    measured worse (bridged background corrupts split recovery) — instead
    each ACCEPTED claim expands at output time, where two gates make the
    growth safe:

    - connectivity: transitive hops from the claim at its own spacing
      (capped 0.45 m), over unlabeled eligible points only (other clusters
      and already-painted points are barred);
    - motion explanation: an expanded point must land on the completed pc1
      evidence under the claim's delta (de-smeared NN residual <= the
      claim-scale tolerance) — a bridged static point shifted by 2+ m lands
      in empty space and is dropped.

    Mutates ``prior``/``prior_valid`` in place."""
    from himo_tpu_torch.models.icp_flow import _cluster_spacing, _desmear

    pool_pts = xyz1[pool1]
    if len(pool_pts) == 0:
        return
    pool_dt = None if dt1 is None else np.asarray(dt1)[pool1]
    dt0 = None if dt0 is None else np.asarray(dt0)
    p0 = pc0_comp[:, :3]
    expandable = eligible0 & (np.asarray(labels0) == 0) & ~prior_valid
    # Two phases: per-claim growth first, then ARGMIN assignment — a merged
    # sibling's claim carries a handful of alias points of the fast member,
    # and first-come expansion from them paints the member's whole interior
    # with the sibling's delta (measured 0.65 m mean err on a 25 m/s
    # instance); each grown point instead goes to the claim whose delta
    # explains it best.
    grown_res = {}  # point index -> (best residual, delta)
    for subset_ix, delta in paint_jobs:
        if float(np.linalg.norm(delta)) < 1e-6:
            continue  # zero claims supervise static; nothing to spread
        seed = p0[subset_ix]
        sp = _cluster_spacing(seed)
        if not np.isfinite(sp):
            continue
        r_hop = float(np.clip(2.5 * sp, 0.15, 0.45))
        # Reach must span the SMEAR: a fast claim's inlier subset can be a
        # strip at one end of a |delta|-long rolling-shutter smear (measured
        # at 65k: a correct 2.5 m/frame claim painted only 45% of its
        # object with the old fixed 3-hop reach) — the far end is still the
        # same object. Every grown point is residual-verified against the
        # pool under the delta below, so on DENSE claims the wider reach
        # cannot leak onto background. On sparse claims (> 0.35 m spacing)
        # that verification has no teeth (the 0.6 m residual cap passes
        # almost anything) and a mis-measured alias delta would smear
        # wider — keep the conservative 3-hop reach there (measured: a
        # 2048-pt subsampled scene's 2.3x alias tipped past raw with the
        # unconditional reach).
        reach = 3 * r_hop
        if sp <= 0.35:
            reach = max(reach, float(np.linalg.norm(delta)) + 2 * r_hop)
        lo = seed.min(0) - reach
        hi = seed.max(0) + reach
        cand_ix = np.flatnonzero(
            expandable & np.all((p0 >= lo) & (p0 <= hi), axis=1)
        )
        if len(cand_ix) == 0:
            continue
        in_set = np.zeros(len(cand_ix), bool)
        grow_seed = seed
        for _ in range(int(np.clip(np.ceil(reach / r_hop), 3, 10))):
            rest = ~in_set
            if not rest.any():
                break
            d_near = nn_residual_distances(p0[cand_ix[rest]], grow_seed)
            grew = np.zeros(len(cand_ix), bool)
            grew[np.flatnonzero(rest)[d_near <= r_hop]] = True
            if not grew.any():
                break
            in_set |= grew
            grow_seed = p0[cand_ix[in_set]]
        grown = cand_ix[in_set]
        if len(grown) == 0:
            continue
        gdt = None if dt0 is None else dt0[grown]
        shifted = _desmear(p0[grown], gdt, delta, period) + delta
        q1 = _desmear(pool_pts, pool_dt, delta, period)
        resid = nn_residual_distances(shifted, q1)
        ok = resid <= min(max(0.3, 1.75 * sp), 0.6)
        for ix, r in zip(grown[ok], resid[ok]):
            ix = int(ix)
            if ix not in grown_res or r < grown_res[ix][0]:
                grown_res[ix] = (float(r), delta)
    for ix, (_, delta) in grown_res.items():
        prior[ix] = delta
        prior_valid[ix] = True


def label_frame(
    data: Dict[str, np.ndarray],
    threshold: float = 0.18,
    eps: float = 0.6,
    min_samples: int = 8,
    with_prior: bool = False,
    tracker=None,
):
    """(dynamic, cluster) labels for one frame-pair dict (needs pc1/gm1).

    ``with_prior=True`` additionally returns (prior, prior_valid) from
    :func:`translation_priors` — a 4-tuple. ``tracker`` (one
    models/icp_flow.ClusterTracker per scene, frames fed in order) adds
    cross-frame velocity continuity to the prior matching."""
    xyz0 = data["pc0"][:, :3]
    xyz1 = data["pc1"][:, :3]
    pflow = rigid_flow(xyz0, data["pose0"], data["pose1"]).astype(np.float32)
    pc0_comp = xyz0 + pflow
    ng0 = ~np.asarray(data["gm0"], bool)
    ng1 = ~np.asarray(data["gm1"], bool)
    dynamic = np.zeros(len(xyz0), dtype=bool)
    dynamic[ng0] = dynamic_mask_from_nn(pc0_comp[ng0], xyz1[ng1], threshold)
    clusters = cluster_dynamic_points(pc0_comp, dynamic, eps, min_samples)
    if not with_prior:
        return dynamic, clusters.astype(np.uint16)
    dynamic1 = np.zeros(len(xyz1), dtype=bool)
    dynamic1[ng1] = dynamic_mask_from_nn(xyz1[ng1], pc0_comp[ng0], threshold)
    prior, prior_valid = translation_priors(
        pc0_comp, clusters, xyz1, dynamic1, eps=eps, min_samples=min_samples,
        dt0=data.get("lidar_dt"), dt1=data.get("lidar_dt1"),
        tracker=tracker, pose1=data.get("pose1"),
        eligible0=ng0, eligible1=ng1,
    )
    return dynamic, clusters.astype(np.uint16), prior, prior_valid


def label_scene(frames, threshold: float = 0.18, label_fn=None):
    """Label one scene's frame pairs IN ORDER, with a scene-start repair.

    Forward pass: one :func:`label_frame` per pair, sharing a
    models/icp_flow.ClusterTracker (velocity continuity). The first pair
    has no track yet — the one place a merged-cluster BLEND or convoy swap
    has nothing to overrule it (measured: the only failures left on the
    bucket-complete diagnostic were at frame 0). Labels are an OFFLINE
    artifact, so after three pairs the first is re-labeled with the
    tracker's confirmed tracks rolled back under constant velocity
    (ClusterTracker.backcast); the repair replaces the stored labels only
    for pair 0.

    ``label_fn(data, tracker)`` overrides the per-pair labeler (the DUFO
    writer fuses occupancy evidence); it must return the 4-tuple of
    :func:`label_frame`. Returns a list of 4-tuples, one per input frame.
    """
    from himo_tpu_torch.models.icp_flow import ClusterTracker

    if label_fn is None:
        def label_fn(data, tracker):
            return label_frame(
                data, threshold=threshold, with_prior=True, tracker=tracker
            )

    tracker = ClusterTracker()
    out = []
    pair_ks = []  # indices of pair-bearing frames, in order
    for k, data in enumerate(frames):
        is_pair = bool(data.get("has_next", True))
        # A trailing frame has no successor: its labels are all-zero by
        # construction, and feeding its empty match set to the tracker
        # would needlessly coast every track — label it tracker-less.
        out.append(label_fn(data, tracker if is_pair else None))
        if not is_pair:
            continue
        pair_ks.append(k)
        if len(pair_ks) == 3:
            # Re-label the first TWO pairs: confirmation (claim tracks AND
            # measured-motion tracks) needs two agreeing pairs, so live
            # tracks only overrule blends/convoy swaps — and only admit a
            # slow mover's sub-tolerance motion past the null/snap — from
            # pair 2 onward. Pair j's pc0 sits ``len(pair_ks) - j`` periods
            # before the tracks' current positions.
            for j, kk in enumerate(pair_ks[:2]):
                back = tracker.backcast(n_frames=len(pair_ks) - j)
                if back.tracks:
                    out[kk] = label_fn(frames[kk], back)
    return out


SSL_KEYS = ("ssl_dynamic", "ssl_cluster", "ssl_prior", "ssl_prior_valid")


def _frames_by_scene(data_dir) -> Tuple[SceneFlowDataset, Dict[str, list]]:
    """Every frame-pair item of a dataset (with pc1, gm1 and the
    successor's ``lidar_dt1``), grouped by scene in index order."""
    dataset = SceneFlowDataset(data_dir, with_pc1=True, next_keys=("lidar_dt",))
    by_scene: Dict[str, list] = {}
    for i in range(len(dataset)):
        data = dataset[i]
        by_scene.setdefault(data["scene_id"], []).append(data)
    return dataset, by_scene


def write_scene_labels(path, labels: Dict[str, Tuple]) -> None:
    """Rewrite one scene file whole with each frame's labels: ``labels``
    maps a group key to ``(dynamic, clusters, prior, prior_valid)``, written
    as ``ssl_dynamic``, ``ssl_cluster``, ``ssl_prior`` and
    ``ssl_prior_valid`` (added, or replacing the file's). Every other
    dataset keeps its bytes, dtype and shape. The new file is written
    beside the old one, then moved over it."""
    path = Path(path)
    groups: Dict[str, Dict[str, np.ndarray]] = {}
    with h5.File(path) as f:
        for key in f.keys():
            group = f[key]
            groups[key] = {}
            for name in group.keys():
                member = group[name]
                if not isinstance(member, h5.Dataset):
                    raise ValueError(f"{path}:{key}/{name}: nested groups are outside "
                                     "the scene format")
                groups[key][name] = member[()]
    for key, arrays in labels.items():
        groups[key].update(zip(SSL_KEYS, arrays))
    tmp = path.with_name(path.name + ".tmp")
    try:
        with h5.File(tmp, "w") as f:
            for key, arrays in groups.items():
                group = f.create_group(key)
                for name, arr in arrays.items():
                    group.create_dataset(name, data=arr)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def _write_labels(dataset, by_scene, label_fn, threshold: float, desc: str,
                  verbose: bool) -> int:
    """Label each scene with :func:`label_scene` and rewrite its file;
    returns frames labelled."""
    n = 0
    for i, (scene_id, frames) in enumerate(by_scene.items()):
        results = label_scene(frames, threshold=threshold, label_fn=label_fn)
        write_scene_labels(
            dataset.directory / f"{scene_id}.h5",
            {str(data["timestamp"]): result for data, result in zip(frames, results)},
        )
        n += len(frames)
        if verbose:
            print(f"{desc}: scene {i + 1}/{len(by_scene)} ({scene_id}), "
                  f"{len(frames)} frames", flush=True)
    return n


def write_ssl_labels(data_dir, threshold: float = 0.18, verbose: bool = True) -> int:
    """Label every frame pair in a dataset; returns frames labeled."""
    dataset, by_scene = _frames_by_scene(data_dir)
    return _write_labels(dataset, by_scene, None, threshold,
                         f"SSL labels for {data_dir}", verbose)


# ---------------------------------------------------------------------------
# DUFOMap-style occupancy-change dynamic classification.
#
# The reference SeFlow label pipeline uses DUFOMap (ray-carved "void"
# regions): a voxel observed OCCUPIED at time t but seen-through (FREE) by
# some other sweep's rays must contain a moving object at t. Unlike the NN
# residual test above, occluded regions are never carved, so occlusion does
# not produce false positives, and slow movers accumulate evidence across
# the whole scene window rather than a single frame pair.
# Host numpy (data-prep artifact, like the NN labels): voxel hashing +
# vectorized ray sampling, no per-ray Python loops.


def _voxel_keys(points: np.ndarray, voxel: float) -> np.ndarray:
    """Pack voxel indices into int64 keys (21 bits per axis, offset 2^20)."""
    ijk = np.floor(points / voxel).astype(np.int64) + (1 << 20)
    return (ijk[:, 0] << 42) | (ijk[:, 1] << 21) | ijk[:, 2]


def _dilate_keys(keys: np.ndarray) -> np.ndarray:
    """All 27-neighborhood voxel keys of the given packed keys.

    Plain packed-key addition is exact here: indices sit mid-range
    (offset 2^20), so per-axis +-1 never under/overflows its bit field."""
    offsets = np.array(
        [
            (dx << 42) + (dy << 21) + dz
            for dx in (-1, 0, 1)
            for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)
        ],
        dtype=np.int64,
    )
    return np.unique((keys[:, None] + offsets[None, :]).reshape(-1))


def _ray_free_keys(
    points: np.ndarray,
    origin: np.ndarray,
    voxel: float,
    samples: int,
    endpoint_margin: float,
) -> np.ndarray:
    """Voxel keys sampled along sensor->point rays, stopping short of the
    endpoint by ``endpoint_margin`` so the surface voxel is never carved."""
    rel = points - origin[None, :]
    dist = np.linalg.norm(rel, axis=1, keepdims=True)
    dist = np.maximum(dist, 1e-6)
    stop = np.maximum(1.0 - endpoint_margin / dist, 0.0)  # (N, 1) fraction
    fracs = (np.arange(samples, dtype=np.float32)[None, :] + 0.5) / samples
    pos = origin[None, None, :] + rel[:, None, :] * (fracs * stop)[:, :, None]
    return np.unique(_voxel_keys(pos.reshape(-1, 3), voxel))


def dufo_scene_labels(
    scene_path,
    voxel: float = 0.4,
    samples: int = 128,
    endpoint_margin: float = 1.0,
    max_points_per_frame: int = 120000,
) -> Dict[str, np.ndarray]:
    """Per-frame dynamic masks for one scene .h5 via occupancy conflict.

    A non-ground point is dynamic when its (world-frame, ego-compensated)
    voxel is ray-carved FREE by any sweep in the scene — the DUFOMap void
    criterion. Returns {timestamp_key: (N,) bool}.
    """
    with h5.File(scene_path) as f:
        keys = sorted(f.keys(), key=lambda k: int(k))
        frames = []
        for k in keys:
            g = f[k]
            pc = g["lidar"][()][:, :3].astype(np.float32)
            gm = (
                np.asarray(g["ground_mask"][()], bool)
                if "ground_mask" in g
                else np.zeros(len(pc), bool)
            )
            frames.append({"key": k, "pc": pc, "gm": gm,
                           "pose": g["pose"][()].astype(np.float64)})

    world, origins = [], []
    for fr in frames:
        R, t = fr["pose"][:3, :3], fr["pose"][:3, 3]
        world.append((fr["pc"] @ R.T + t).astype(np.float32))
        origins.append(t.astype(np.float32))

    free_sets = []
    for w, o, fr in zip(world, origins, frames):
        pts = w[~fr["gm"]][:max_points_per_frame]
        rays = _ray_free_keys(pts, o, voxel, samples, endpoint_margin)
        # DUFOMap's protection margin: this sweep's own hits (dilated one
        # voxel) are never carved by its rays — static voxels, occupied in
        # every sweep, therefore never enter any free set, and grazing rays
        # can't erode surfaces they also observe.
        occupied = _dilate_keys(np.unique(_voxel_keys(w, voxel)))
        free_sets.append(rays[~np.isin(rays, occupied)])
    free_union = np.unique(np.concatenate(free_sets)) if free_sets else np.array([], np.int64)

    out = {}
    for w, fr in zip(world, frames):
        keys_pts = _voxel_keys(w, voxel)
        dynamic = np.isin(keys_pts, free_union, assume_unique=False)
        dynamic &= ~fr["gm"]
        out[fr["key"]] = dynamic
    return out


def fuse_dynamic_evidence(
    points: np.ndarray,
    nn_dyn: np.ndarray,
    dufo_dyn: np.ndarray,
    not_ground: np.ndarray,
    eps: float = 0.8,
    min_samples: int = 5,
    dufo_vote: float = 0.15,
    nn_vote: float = 0.8,
    max_clusters: int = 63,
):
    """Cluster-level vote: DBSCAN the union candidates; a cluster is dynamic
    when the precise DUFO occupancy evidence covers >= ``dufo_vote`` of it
    (or the NN residual evidence is near-unanimous). Returns
    (dynamic, cluster_ids) — measured on synthetic scenes this fusion keeps
    DUFO's perfect precision while beating the NN labels' recall."""
    cand = (nn_dyn | dufo_dyn) & not_ground
    dynamic = np.zeros(len(points), bool)
    labels = np.zeros(len(points), np.uint16)
    idx = np.flatnonzero(cand)
    if len(idx) < min_samples:
        return dynamic, labels
    raw = _dbscan_adaptive(points[idx, :3], eps, min_samples)
    kept = []
    # Unique ids only: the fragment merge relabels clusters into others,
    # leaving id gaps whose empty slices would nan the vote means.
    for c in np.unique(raw[raw >= 0]):
        m = idx[raw == c]
        if dufo_dyn[m].mean() >= dufo_vote or nn_dyn[m].mean() >= nn_vote:
            kept.append(m)
    kept.sort(key=len, reverse=True)
    for rank, m in enumerate(kept[:max_clusters]):
        dynamic[m] = True
        labels[m] = rank + 1
    return dynamic, labels


def write_ssl_labels_dufo(
    data_dir,
    voxel: float = 0.4,
    samples: int = 128,
    endpoint_margin: float = 1.0,
    threshold: float = 0.18,
    verbose: bool = True,
) -> int:
    """DUFOMap-style labels: ray-carved occupancy evidence fused with the
    NN residual candidates at cluster level; same ssl_dynamic/ssl_cluster
    write-back contract as the NN variant. Returns frames labeled."""
    dufo_masks = {}
    for scene in sorted(Path(data_dir).glob("*.h5")):
        dufo_masks[scene.stem] = dufo_scene_labels(
            scene, voxel=voxel, samples=samples, endpoint_margin=endpoint_margin
        )

    dataset, by_scene = _frames_by_scene(data_dir)

    def dufo_label_fn(data, tracker):
        """Fused-evidence labeler (label_scene contract): clusters from the
        NN+DUFO cluster vote; priors ride the fused clusters (cluster
        geometry is in the ego-compensated frame, like label_frame's)."""
        nn_dyn, _ = label_frame(data, threshold=threshold)
        du_dyn = dufo_masks[data["scene_id"]][str(data["timestamp"])]
        dynamic, clusters = fuse_dynamic_evidence(
            data["pc0"][:, :3],
            nn_dyn,
            du_dyn,
            ~np.asarray(data["gm0"], bool),
        )
        xyz0 = data["pc0"][:, :3]
        xyz1 = data["pc1"][:, :3]
        pflow = rigid_flow(xyz0, data["pose0"], data["pose1"]).astype(np.float32)
        pc0_comp = xyz0 + pflow
        ng0 = ~np.asarray(data["gm0"], bool)
        ng1 = ~np.asarray(data["gm1"], bool)
        dynamic1 = np.zeros(len(xyz1), bool)
        dynamic1[ng1] = dynamic_mask_from_nn(xyz1[ng1], pc0_comp[ng0], threshold)
        prior, prior_valid = translation_priors(
            pc0_comp, clusters.astype(np.int64), xyz1, dynamic1,
            dt0=data.get("lidar_dt"), dt1=data.get("lidar_dt1"),
            tracker=tracker, pose1=data.get("pose1"),
            eligible0=ng0, eligible1=ng1,
        )
        return dynamic, clusters, prior, prior_valid

    return _write_labels(dataset, by_scene, dufo_label_fn, threshold,
                         f"DUFO labels {data_dir}", verbose)
