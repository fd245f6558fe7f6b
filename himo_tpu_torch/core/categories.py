"""Argoverse 2 annotation taxonomy and metacategory buckets (a copy of
``himo_tpu/core/categories.py``, so the port imports nothing of the JAX
package).

Ground-truth tables follow the copies vendored by the reference's standalone
scorer (tools/test/score.py:29-94) and segmentation eval
(downstream/eval_seg.py:24-93), which SURVEY.md §2.9 declares
authoritative for the absent ``src.utils.av2_eval`` module.
"""

from __future__ import annotations

from typing import Dict, List

# Ordered AV2 sensor-dataset annotation categories; index mapping is
# NONE=0 then 1-indexed in this order (score.py:29-64).
ANNOTATION_CATEGORIES: List[str] = [
    "ANIMAL",
    "ARTICULATED_BUS",
    "BICYCLE",
    "BICYCLIST",
    "BOLLARD",
    "BOX_TRUCK",
    "BUS",
    "CONSTRUCTION_BARREL",
    "CONSTRUCTION_CONE",
    "DOG",
    "LARGE_VEHICLE",
    "MESSAGE_BOARD_TRAILER",
    "MOBILE_PEDESTRIAN_CROSSING_SIGN",
    "MOTORCYCLE",
    "MOTORCYCLIST",
    "OFFICIAL_SIGNALER",
    "PEDESTRIAN",
    "RAILED_VEHICLE",
    "REGULAR_VEHICLE",
    "SCHOOL_BUS",
    "SIGN",
    "STOP_SIGN",
    "STROLLER",
    "TRAFFIC_LIGHT_TRAILER",
    "TRUCK",
    "TRUCK_CAB",
    "VEHICULAR_TRAILER",
    "WHEELCHAIR",
    "WHEELED_DEVICE",
    "WHEELED_RIDER",
]

CATEGORY_TO_INDEX: Dict[str, int] = {"NONE": 0}
CATEGORY_TO_INDEX.update({cat: i + 1 for i, cat in enumerate(ANNOTATION_CATEGORIES)})
INDEX_TO_CATEGORY: Dict[int, str] = {v: k for k, v in CATEGORY_TO_INDEX.items()}

PEDESTRIAN_CATEGORIES = ["PEDESTRIAN", "STROLLER", "WHEELCHAIR", "OFFICIAL_SIGNALER"]
WHEELED_VRU = [
    "BICYCLE",
    "BICYCLIST",
    "MOTORCYCLE",
    "MOTORCYCLIST",
    "WHEELED_DEVICE",
    "WHEELED_RIDER",
]
CAR = ["REGULAR_VEHICLE"]
OTHER_VEHICLES = [
    "BOX_TRUCK",
    "LARGE_VEHICLE",
    "RAILED_VEHICLE",
    "TRUCK",
    "TRUCK_CAB",
    "VEHICULAR_TRAILER",
    "ARTICULATED_BUS",
    "BUS",
    "SCHOOL_BUS",
]
BACKGROUND_CATEGORIES = ["NONE"]

BUCKETED_METACATAGORIES: Dict[str, List[str]] = {
    "BACKGROUND": BACKGROUND_CATEGORIES,
    "CAR": CAR,
    "PEDESTRIAN": PEDESTRIAN_CATEGORIES,
    "WHEELED_VRU": WHEELED_VRU,
    "OTHER_VEHICLES": OTHER_VEHICLES,
}

# Margin added when growing GT boxes during flow autolabeling so sweep-skewed
# points still fall inside (consumed at reference dataprocess/extract_sca.py:111-114).
BOUNDING_BOX_EXPANSION: float = 0.2

# Source-taxonomy -> AV2 name remapping for pseudo-label ingestion.
# KITTI- and nuScenes-style names from the reference's downstream/eval_seg.py:29-72;
# AV2 names map to themselves so ``NAME_MAPPING`` works for all label sources.
NAME_MAPPING_KITTI = {
    "outlier": "NONE",
    "unlabeled": "NONE",
    "car": "REGULAR_VEHICLE",
    "bicycle": "BICYCLE",
    "motorcycle": "MOTORCYCLE",
    "truck": "TRUCK",
    "other-vehicle": "LARGE_VEHICLE",
    "person": "PEDESTRIAN",
    "bicyclist": "BICYCLIST",
    "motorcyclist": "MOTORCYCLIST",
    "road": "NONE",
    "parking": "NONE",
    "sidewalk": "NONE",
    "other-ground": "NONE",
    "building": "NONE",
    "fence": "NONE",
    "vegetation": "NONE",
    "trunk": "NONE",
    "terrain": "NONE",
    "pole": "NONE",
    "traffic-sign": "SIGN",
}

NAME_MAPPING_NUSCENES = {
    "ignore": "NONE",
    "barrier": "NONE",
    "bicycle": "BICYCLE",
    "bus": "BUS",
    "car": "REGULAR_VEHICLE",
    "construction_vehicle": "LARGE_VEHICLE",
    "motorcycle": "MOTORCYCLE",
    "pedestrian": "PEDESTRIAN",
    "traffic_cone": "NONE",
    "trailer": "VEHICULAR_TRAILER",
    "truck": "TRUCK",
    "driveable_surface": "NONE",
    "other_flat": "NONE",
    "sidewalk": "NONE",
    "terrain": "NONE",
    "manmade": "NONE",
    "vegetation": "NONE",
}

# Unified mapping used by the Scania autolabeler (extract_sca.py:139 consumes
# ``NameMapping``): nuScenes + KITTI names, AV2 names pass through, and the
# sentinel 'none' (appended for background at extract_sca.py:137) maps to NONE.
NAME_MAPPING: Dict[str, str] = {}
NAME_MAPPING.update(NAME_MAPPING_KITTI)
NAME_MAPPING.update(NAME_MAPPING_NUSCENES)
NAME_MAPPING.update({cat: cat for cat in ANNOTATION_CATEGORIES})
NAME_MAPPING.update({"NONE": "NONE", "none": "NONE"})
