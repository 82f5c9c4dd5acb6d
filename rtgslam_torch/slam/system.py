"""Two-stage tracker / mapper pipeline (the reference's multi-process mode).

Port of ``rtgslam_tpu/slam/system.py`` (reference ``slam_mp.py`` +
``SLAM/multiprocess/system.py``): the tracker and the mapper run as two host
threads, and a third drains mid-run checkpoints to PLY.  The three sync
policies of the reference (``system.py:19-24``, ``tracker.py:469-487``):

  strict  the tracker waits every ``sync_tracker2mapper_frames`` frames
          until the mapper has mapped its frame;
  loose   the tracker runs at most that many frames ahead;
  free    no synchronization.

On CUDA each compute thread enters its own ``torch.cuda.Stream`` (the
current stream is per thread, and the blend kernels launch on it), so the
tracker's and the mapper's kernels can overlap on one card.  ``device_list``
maps to ``cuda:i`` (mapper on ``device_list[0]``, tracker on
``device_list[1]`` when given, the JAX rank order :69-76); with one entry
both threads share one card on two streams.

Cross-stream hand-offs.  The port updates the map in place (the JAX package
donates buffers instead), so every tensor that crosses between threads is
handed over as follows (:func:`_publish` / :func:`_receive`):

  * the producer makes its own copy where the tensor would otherwise alias
    state it keeps writing (the mapper's snapshot for the tracker clones
    every tensor of ``render_inputs``, not only ``xyz``), then records a
    ``torch.cuda.Event`` on its stream;
  * the consumer's stream waits on that event before any use, and each
    tensor gets ``record_stream`` on the consumer's stream, so the caching
    allocator cannot hand its memory out again while the consumer's queued
    work still reads it.

The tracked frame maps go tracker -> mapper the same way.  A race here
would give a wrong map only sometimes; ``chip_smoke.py`` runs the strict /
1-frame policy twice and compares the runs.

Clocks.  ``utils/general.py::sync`` waits for the whole device, both streams;
inside the threads each clock is read after the thread's own
``torch.cuda.current_stream().synchronize()``, so neither stage is charged
the other's work.  Both loops are host-bound and share the interpreter lock,
so the pipelined frame time may sit near the sum of tracking and mapping
rather than their maximum (``run`` returns the wall time to compare).

``blend.launches`` is one dict both threads add to: count a run's launches
before and after it, not per thread.
"""

from __future__ import annotations

import contextlib
import os
import queue
import threading
import time
from typing import Dict, List, Optional

import torch

from ..config import DatasetParams
from ..data.dataset import Dataset
from ..data.loader import FrameLoader
from ..models.gaussian_map import alive_mask, render_inputs
from ..ops.rasterize import RasterSettings, render
from ..utils.general import require_device
from ..utils.monitor import Recorder
from .eval import eval_frame
from .mapper import Mapper, PrioritySource
from .tracker import Tracker


def _publish(tensors: Dict[str, torch.Tensor]):
    """An event on the current stream after the work that produced
    ``tensors`` (None on the CPU)."""
    if not any(t.is_cuda for t in tensors.values()):
        return None
    event = torch.cuda.Event()
    event.record()
    return event


def _receive(tensors: Dict, event, device: torch.device) -> Dict:
    """Make the current stream wait for the producer's ``event`` and mark
    each tensor as used on it; a tensor from another card is copied to
    ``device`` instead, and the copies complete before this returns, so the
    producer may free the sources."""
    if event is None:
        return tensors
    stream = torch.cuda.current_stream()
    stream.wait_event(event)
    out, copied = {}, False
    for k, v in tensors.items():
        if torch.is_tensor(v) and v.is_cuda:
            if v.device == device:
                v.record_stream(stream)
            else:
                v, copied = v.to(device), True
        out[k] = v
    if copied:
        stream.synchronize()
    return out


@contextlib.contextmanager
def _own_stream(device: torch.device):
    """Run the calling thread on a stream of its own on ``device``, ordered
    after the work the constructor queued on the default stream."""
    if device.type != "cuda":
        yield
        return
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.default_stream(device))
    with torch.cuda.device(device), torch.cuda.stream(stream):
        yield


def _stream_sync(device: torch.device) -> None:
    """Wait for the calling thread's stream alone (not the device)."""
    if device.type == "cuda":
        torch.cuda.current_stream().synchronize()


class SLAM:
    """The pipelined system on ``device`` (CUDA unless the caller asks for
    the CPU; on CUDA, ``device_list`` picks the cards)."""

    def __init__(self, args, dataset: Dataset, optimization_params,
                 device="cuda", priority_source: Optional[PrioritySource] = None):
        self.args = args
        self.dataset = dataset
        self.optimization_params = optimization_params
        self.sync_method = args.sync_tracker2mapper_method
        self.sync_frames = int(args.sync_tracker2mapper_frames)
        self.tracker_max_fps = float(getattr(args, "tracker_max_fps", 30))

        base = require_device(device)
        if base.type == "cuda":
            n = torch.cuda.device_count()
            dl = list(getattr(args, "device_list", None) or [0])
            self.mapper_device = torch.device("cuda", int(dl[0]) % n)
            self.tracker_device = (torch.device("cuda", int(dl[1]) % n)
                                   if len(dl) > 1 else self.mapper_device)
        else:
            self.mapper_device = self.tracker_device = base
        self.two_device = self.mapper_device != self.tracker_device

        self.recorder = Recorder(self.mapper_device.index or 0,
                                 record_mem=getattr(args, "record_mem", False))
        self.tracker = Tracker(args, self.tracker_device)
        self.mapper = Mapper(args, self.mapper_device, priority_source)

        self._t2m: queue.Queue = queue.Queue()
        self._m2t: queue.Queue = queue.Queue()
        # mapper -> saver: host snapshots drained to PLY mid-run (the
        # reference system process's save-model queue, system.py:57-87)
        self._save_q: queue.Queue = queue.Queue()
        self._mapper_caught_up = threading.Condition()
        self._last_mapped_frame = -1
        self._errors: List[BaseException] = []
        self._track_settings = None
        # host clock (perf_counter) when each frame's mapping ended
        self.map_end: Dict[int, float] = {}
        self.decode_ms: Dict[int, float] = {}

    # ------------------------------------------------------------------
    def _tracking_loop(self):
        try:
            with _own_stream(self.tracker_device):
                self._tracking_loop_impl()
        except Exception as e:  # surfaced in run()
            self._errors.append(e)
        finally:
            self._t2m.put(None)   # end sentinel (reference time == -1)

    def _tracking_loop_impl(self):
        dev = self.tracker_device
        infos = self.dataset.scene_info.train_cameras
        min_frame_time = 1.0 / self.tracker_max_fps
        loader = FrameLoader(DatasetParams().extract(self.args), infos, prefetch=4)
        try:
            for frame_id, frame in enumerate(loader):
                if self._errors:
                    return
                _stream_sync(dev)
                start = time.perf_counter()
                frame_map = self.tracker.map_preprocess(frame, frame_id)
                self.tracker.tracking(frame, frame_map)
                _stream_sync(dev)
                self.recorder.update_mean("tracking", time.perf_counter() - start, 1)
                maps = {k: v for k, v in frame_map.items() if torch.is_tensor(v)}
                self._t2m.put((frame, frame_map, _publish(maps), frame_id,
                               self.tracker.get_new_poses()))

                # sync policies (reference tracker.py:469-487)
                if self.sync_method == "strict":
                    if (frame_id + 1) % self.sync_frames == 0:
                        with self._mapper_caught_up:
                            while self._last_mapped_frame < frame_id:
                                self._mapper_caught_up.wait(timeout=30.0)
                elif self.sync_method == "loose":
                    with self._mapper_caught_up:
                        while frame_id - self._last_mapped_frame > self.sync_frames:
                            self._mapper_caught_up.wait(timeout=30.0)

                # the mapper's latest snapshot, rendered at the TRACKER's
                # pose for frame-to-model ICP (reference
                # update_last_mapper_render, tracker.py:522-538)
                snapshot = None
                while not self._m2t.empty():
                    snapshot = self._m2t.get_nowait()
                if snapshot is not None:
                    gauss = _receive(snapshot["gauss"], snapshot["event"], dev)
                    if self._track_settings is None:
                        self._track_settings = RasterSettings.from_args(
                            self.args, frame.image_height, frame.image_width)
                    out = render(gauss, frame.device_dict(dev), self._track_settings)
                    self.tracker.update_last_status(
                        frame, out["depth"], frame_map["depth_map"],
                        out["normal"], frame_map["normal_map_w"])

                elapsed = time.perf_counter() - start
                if elapsed < min_frame_time:
                    time.sleep(min_frame_time - elapsed)
        finally:
            self.decode_ms = dict(loader.decode_ms)
            loader.close()

    def _mapping_loop(self):
        try:
            with _own_stream(self.mapper_device):
                self._mapping_loop_impl()
        except Exception as e:  # surfaced in run()
            self._errors.append(e)
            with self._mapper_caught_up:
                self._last_mapped_frame = 10 ** 9
                self._mapper_caught_up.notify_all()

    def _mapping_loop_impl(self):
        dev = self.mapper_device
        mapper = self.mapper
        while True:
            item = self._t2m.get()
            if item is None:
                break
            frame, frame_map, event, frame_id, new_poses = item
            frame_map = _receive(frame_map, event, dev)
            _stream_sync(dev)
            start = time.perf_counter()
            mapper.update_poses(new_poses)
            mapper.mapping(frame, frame_map, frame_id, self.optimization_params)
            # mid-run checkpoint and eval, the single-process cadence; the
            # host snapshot is taken here, the PLY writing drains on the
            # saver thread
            if (mapper.time + 1) % mapper.save_step == 0 or mapper.time == 0:
                self._save_q.put(mapper.snapshot_host())
                metrics = eval_frame(
                    mapper, frame, os.path.join(self.args.save_path, "eval_render"),
                    min_depth=self.args.min_depth, max_depth=self.args.max_depth,
                    save_picture=True)
                print(f"[EVAL] frame {frame_id}: psnr {metrics['psnr']:.2f} "
                      f"depthL1 {metrics['depth_l1_cm']:.2f}cm")
            mapper.time += 1
            # a private copy of every tensor the tracker will render (the
            # map changes in place under the next frame's mapping)
            gauss = {k: v.clone() for k, v in
                     render_inputs(mapper.state, alive_mask(mapper.state)).items()}
            self._m2t.put({"gauss": gauss, "event": _publish(gauss),
                           "frame_id": frame_id})
            _stream_sync(dev)
            self.map_end[frame_id] = time.perf_counter()
            self.recorder.update_mean("mapping", self.map_end[frame_id] - start, 1)
            with self._mapper_caught_up:
                self._last_mapped_frame = frame_id
                self._mapper_caught_up.notify_all()
        if not self._errors:
            # the final global optimization (reference mapper.py:1246)
            mapper.global_optimization(self.optimization_params)

    def _saver_loop(self):
        """Drain mid-run snapshots to the reference PLY layout: file I/O
        never blocks the mapping loop (reference system.py:57-87)."""
        try:
            while True:
                snap = self._save_q.get()
                if snap is None:
                    break
                self.mapper.save_snapshot(snap)
        except Exception as e:  # surfaced in run()
            self._errors.append(e)

    # ------------------------------------------------------------------
    def run(self) -> Dict:
        """Run the three threads to the end, then save the model, the
        trajectory and ``performance.json``.  Returns ate_cm, fps, the wall
        seconds of the threaded run, the per-frame mapping end times, the
        loader's decode milliseconds, the mapper, tracker and recorder."""
        threads = [threading.Thread(target=fn, name=name) for fn, name in (
            (self._saver_loop, "saver"), (self._mapping_loop, "mapper"),
            (self._tracking_loop, "tracker"))]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        threads[2].join()
        threads[1].join()
        self._save_q.put(None)      # drain the remaining snapshots, then stop
        threads[0].join()
        for dev in {self.mapper_device, self.tracker_device}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall_s = time.perf_counter() - t0
        if self._errors:
            raise self._errors[0]

        self.mapper.save_model(save_data=True)
        ate = self.tracker.save_traj(self.args.save_path)
        fps = self.recorder.cal_fps()
        self.recorder.save(self.args.save_path)
        print(f"[LOG] ATE RMSE: {ate:.3f} cm  mapping FPS: {fps:.2f}  "
              f"max bin_overflow: {self.mapper.max_overflow}")
        return {"ate_cm": ate, "fps": fps, "wall_s": wall_s,
                "map_end": dict(self.map_end),
                "decode_ms": self.decode_ms, "mapper": self.mapper,
                "tracker": self.tracker, "recorder": self.recorder}
