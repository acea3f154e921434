"""Minimal COCO-json index (pycocotools replacement), the port's copy of
``das_tpu/datasets/coco_index.py``.

The reference depends on pycocotools/xtcocotools via mmdet's CocoDataset;
this environment has neither, and the DAS datasets only need a thin slice:
image listing, per-image annotation lookup, and category ids. This is a
fresh ~80-line implementation of exactly that slice.
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, List


class CocoIndex:
    def __init__(self, ann_file: str):
        with open(ann_file) as f:
            data = json.load(f)
        self.dataset = data
        self.imgs: Dict[int, dict] = {im['id']: im
                                      for im in data.get('images', [])}
        self.anns: Dict[int, dict] = {a['id']: a
                                      for a in data.get('annotations', [])}
        self.cats: Dict[int, dict] = {c['id']: c
                                      for c in data.get('categories', [])}
        self.img_to_anns: Dict[int, List[int]] = defaultdict(list)
        for a in data.get('annotations', []):
            self.img_to_anns[a['image_id']].append(a['id'])

    # -- pycocotools-compatible surface ---------------------------------
    def get_img_ids(self) -> List[int]:
        return list(self.imgs.keys())

    def get_cat_ids(self, cat_names=None) -> List[int]:
        if cat_names is None:
            return list(self.cats.keys())
        names = set(cat_names)
        return [cid for cid, c in self.cats.items() if c['name'] in names]

    def get_ann_ids(self, img_ids=None) -> List[int]:
        if img_ids is None:
            return list(self.anns.keys())
        out = []
        for i in img_ids:
            out.extend(self.img_to_anns.get(i, []))
        return out

    def load_imgs(self, ids) -> List[dict]:
        return [self.imgs[i] for i in ids]

    def load_anns(self, ids) -> List[dict]:
        return [self.anns[i] for i in ids]

    def load_cats(self, ids) -> List[dict]:
        return [self.cats[i] for i in ids]
