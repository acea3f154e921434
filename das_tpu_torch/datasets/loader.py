"""Host-side batching at fixed shapes, the port's copy of
``das_tpu/datasets/loader.py``.

The reference leans on torch DataLoader + DataContainer collate with
per-batch dynamic padding (SURVEY.md §1 data flow). This loader, as the JAX
one:

* pads every train image to ONE fixed bucket derived from the config's
  max ``img_scale`` (÷32), so every step has the same shapes,
* pads ground truths to a fixed ``max_gt`` with a validity mask
  (consumed by the fixed-shape target assignment),
* overlaps the CPU augmentation pipeline with device compute via a
  background thread pool prefetcher, or — ``worker_type='process'`` —
  a spawn-based worker-process pool (ref exp_panoptic.py:160
  workers_per_gpu): each worker rebuilds the dataset from its config and
  runs whole batches, so the augmentation pipeline escapes the GIL on
  multi-core hosts. Batches are sequence-tagged and reordered.

The shuffle is ``RandomState(seed)`` over epochs, as in JAX. Each sample
also gets a generator of its own, seeded from (seed, epoch, position in the
epoch's order), from which its transforms draw (``dataset.sample(idx,
rng)``). So the thread and process loaders give the same batches bit for
bit with the random pipeline too; the JAX loader's transforms share the
global ``np.random`` across threads, so its random batches depend on the
threads' timing.
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from queue import Empty, Queue
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def pad_batch(samples, pad_hw: Tuple[int, int], max_gt: int,
              num_joints: int) -> Dict[str, np.ndarray]:
    """Collate pipeline outputs into fixed-shape arrays."""
    B = len(samples)
    H, W = pad_hw
    J = num_joints
    img = np.zeros((B, H, W, 3), np.float32)
    poses = np.zeros((B, max_gt, 3 + 4 * J), np.float32)
    centers = np.zeros((B, max_gt, 2), np.float32)
    depths = np.zeros((B, max_gt), np.float32)
    valid = np.zeros((B, max_gt), bool)
    for i, s in enumerate(samples):
        im = s['img']
        img[i, :im.shape[0], :im.shape[1]] = im
        g = min(len(s['gt_poses_3d']), max_gt)
        if g > 0:
            poses[i, :g] = s['gt_poses_3d'][:g]
            centers[i, :g] = s['centers2d'][:g]
            depths[i, :g] = s['depths'][:g]
            valid[i, :g] = True
    return dict(img=img, gt_poses_3d=poses, gt_centers2d=centers,
                gt_depths=depths, gt_valid=valid)


def sample_rng(seed: int, epoch: int,
               position: int) -> np.random.RandomState:
    """The generator of the sample at ``position`` of epoch ``epoch``'s
    order, for a loader seeded ``seed``."""
    state = np.random.SeedSequence([seed, epoch, position]).generate_state(4)
    return np.random.RandomState(state)


def _load_batch(dataset, idxs, keys, seed, pad_hw, max_gt, num_joints,
                pool=None):
    def one(i):
        return dataset.sample(int(idxs[i]), sample_rng(seed, *keys[i]))
    items = range(len(idxs))
    samples = list(pool.map(one, items) if pool else map(one, items))
    return pad_batch(samples, pad_hw, max_gt, num_joints)


def _process_worker_main(dataset_cfg, seed, pad_hw, max_gt, num_joints,
                         task_q, res_q):
    """Spawned worker: rebuild the dataset, collate whole batches. It never
    touches a card."""
    import os
    os.environ['CUDA_VISIBLE_DEVICES'] = ''
    try:
        from .builder import build_dataset
        ds = build_dataset(dataset_cfg)
    except BaseException as e:
        res_q.put((-1, e))
        return
    while True:
        task = task_q.get()
        if task is None:
            return
        seq, idxs, keys = task
        try:
            res_q.put((seq, _load_batch(ds, idxs, keys, seed, pad_hw,
                                        max_gt, num_joints)))
        except BaseException as e:
            res_q.put((seq, e))


class TrainLoader:
    """Shuffled, prefetching train loader with fixed output shapes.

    ``dataset.sample(idx, rng)`` gives a sample. ``worker_type='thread'``
    (default) runs the pipeline in a GIL-shared thread pool; ``'process'``
    spawns worker processes that rebuild the dataset from ``dataset_cfg``
    (required then): the same batches in the same order.
    """

    def __init__(self, dataset, batch_size: int, pad_hw: Tuple[int, int],
                 num_joints: int, max_gt: int = 32, seed: int = 0,
                 num_workers: int = 4, prefetch: int = 2,
                 shard_id: int = 0, num_shards: int = 1,
                 worker_type: str = 'thread',
                 dataset_cfg: Optional[dict] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_hw = pad_hw
        self.max_gt = max_gt
        self.num_joints = num_joints
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.num_workers = num_workers
        self.worker_type = worker_type
        self.dataset_cfg = dataset_cfg
        if worker_type == 'process':
            assert dataset_cfg is not None, \
                "worker_type='process' needs dataset_cfg (workers " \
                "rebuild the dataset; the built one is not shipped)"
        else:
            assert worker_type == 'thread', worker_type
            self.pool = ThreadPoolExecutor(max_workers=num_workers)
        self.prefetch = prefetch
        # several processes: every one draws the same shuffled order (same
        # seed) and takes its interleaved shard, as mmdet's
        # DistributedGroupSampler (SURVEY.md §2.2)
        self.shard_id = shard_id
        self.num_shards = num_shards
        self.steps_per_epoch = max(
            len(dataset) // num_shards // batch_size, 1)

    def _epoch_order(self):
        order = np.arange(len(self.dataset))
        self.rng.shuffle(order)
        return order[self.shard_id::self.num_shards]

    def _index_batches(self):
        """Infinite stream of (indices, [(epoch, position)]) per batch
        (epoch reshuffles); a position counts in the unsharded order."""
        epoch = 0
        while True:
            order = self._epoch_order()
            n = len(order)
            if n < self.batch_size:
                # tiny dataset/shard: sample with replacement
                order = np.concatenate(
                    [order] * (self.batch_size // max(n, 1) + 1))
            for start in range(0, len(order) - self.batch_size + 1,
                               self.batch_size):
                pos = range(start, start + self.batch_size)
                yield (order[start:start + self.batch_size],
                       [(epoch, p * self.num_shards + self.shard_id)
                        for p in pos])
            epoch += 1

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        if self.worker_type == 'process':
            yield from self._iter_process()
            return
        queue: 'Queue' = Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            try:
                for idxs, keys in self._index_batches():
                    if stop.is_set():
                        return
                    queue.put(_load_batch(
                        self.dataset, idxs, keys, self.seed, self.pad_hw,
                        self.max_gt, self.num_joints, self.pool))
            except BaseException as e:   # propagate into the consumer
                queue.put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = queue.get()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # make room for a producer blocked on a full queue, so that it
            # sees the stop and ends
            try:
                while True:
                    queue.get_nowait()
            except Empty:
                pass

    def _iter_process(self) -> Iterator[Dict[str, np.ndarray]]:
        import multiprocessing as mp
        ctx = mp.get_context('spawn')
        task_q = ctx.Queue()
        res_q = ctx.Queue()
        procs = [ctx.Process(
            target=_process_worker_main,
            args=(self.dataset_cfg, self.seed, self.pad_hw, self.max_gt,
                  self.num_joints, task_q, res_q),
            daemon=True) for _ in range(self.num_workers)]
        for p in procs:
            p.start()
        batches = self._index_batches()
        buf: Dict[int, object] = {}
        dispatched = yielded = 0
        inflight = self.num_workers + self.prefetch
        try:
            for _ in range(inflight):
                task_q.put((dispatched, *next(batches)))
                dispatched += 1
            while True:
                while yielded not in buf:
                    try:
                        seq, item = res_q.get(timeout=5)
                    except Empty:
                        dead = [p.exitcode for p in procs
                                if not p.is_alive()]
                        if dead:
                            raise RuntimeError(
                                f'a loader worker ended (exit codes '
                                f'{dead})') from None
                        continue
                    if seq < 0 or isinstance(item, BaseException):
                        raise item
                    buf[seq] = item
                item = buf.pop(yielded)
                yielded += 1
                task_q.put((dispatched, *next(batches)))
                dispatched += 1
                yield item
        finally:
            for p in procs:
                p.terminate()
            for p in procs:
                p.join(timeout=2)


def train_pad_hw_from_cfg(pipeline_cfg) -> Tuple[int, int]:
    """Derive the fixed train bucket from the ResizePose img_scale."""
    for t in pipeline_cfg:
        if t.get('type') in ('ResizePose', 'Resize') and 'img_scale' in t:
            scales = t['img_scale']
            if not isinstance(scales[0], (list, tuple)):
                scales = [scales]
            h = max(min(s) for s in scales)
            w = max(max(s) for s in scales)
            pad = lambda v: int(np.ceil(v / 32)) * 32
            return pad(h), pad(w)
    return 640, 1344
