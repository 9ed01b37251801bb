"""Failure detection / clean-restart (utils.failover, SURVEY §5).

The reference has nothing to port here (its only handling is a GL
context-loss try/catch, pathtracerWGL2.js:70-77); these tests pin this
build's subsystem: hang detection via watchdog threads, device-error
classification, host-mirrored checkpoints that never read a dead device,
and accumulation resume.
"""

import time

import numpy as np
import pytest

from flexlight_tpu.models.pathtracer import PathTracer
from flexlight_tpu.utils.failover import (DeviceLostError, FailoverRunner,
                                          run_supervised)
from tests.scenes import cornell_config, cornell_scene


class _XlaRuntimeError(RuntimeError):
    """Stand-in with jaxlib's class name shape ('Runtime' classifies)."""


class _StubRenderer:
    """Minimal duck-type for FailoverRunner: script per-frame behavior."""

    def __init__(self, script):
        self.script = list(script)
        from flexlight_tpu import Config

        self.config = Config()
        self.width = self.height = 4
        self._frame_count = 0
        self._temporal_state = None
        self._taa_state = None

    def render_frame(self):
        action = self.script.pop(0)
        if action == "hang":
            time.sleep(30.0)
        if isinstance(action, BaseException):
            raise action
        self._frame_count += 1
        return np.zeros((4, 4, 3), np.float32)


def test_hang_detected_within_timeout(tmp_path):
    r = _StubRenderer(["ok", "hang"])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), mirror_every=1,
                            timeout_s=0.3)
    runner.step()
    t0 = time.perf_counter()
    with pytest.raises(DeviceLostError) as e:
        runner.step()
    assert time.perf_counter() - t0 < 5.0  # did not wait out the hang
    # a healthy mirror existed (mirror_every=1) -> checkpoint written
    assert e.value.checkpoint_path == str(tmp_path / "s.npz")


def test_device_error_classified_and_checkpointed(tmp_path):
    r = _StubRenderer(["ok", _XlaRuntimeError("DEADLINE_EXCEEDED")])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), mirror_every=1,
                            timeout_s=10.0)
    runner.step()
    with pytest.raises(DeviceLostError):
        runner.step()
    assert (tmp_path / "s.npz").exists()


def test_programming_errors_propagate_unchanged(tmp_path):
    r = _StubRenderer([ValueError("bug")])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), timeout_s=10.0)
    with pytest.raises(ValueError, match="bug"):
        runner.step()


def test_no_mirror_means_no_checkpoint(tmp_path):
    r = _StubRenderer([_XlaRuntimeError("boom")])
    runner = FailoverRunner(r, str(tmp_path / "s.npz"), timeout_s=10.0)
    with pytest.raises(DeviceLostError) as e:
        runner.step()
    assert e.value.checkpoint_path is None
    assert not (tmp_path / "s.npz").exists()


def _tiny_pathtracer():
    scene, camera = cornell_scene()
    config = cornell_config(temporal=True, temporal_samples=2,
                            max_reflections=2)
    return PathTracer(16, 16, scene, camera, config)


def test_mirror_resume_roundtrip(tmp_path):
    """A real renderer: crash after the mirror, resume in a fresh renderer,
    accumulation state matches the mirrored frame exactly."""
    path = str(tmp_path / "state.npz")
    pt = _tiny_pathtracer()
    runner = FailoverRunner(pt, path, mirror_every=2, timeout_s=60.0)
    runner.step()
    runner.step()   # mirror refreshed here (mirror_every=2)
    mirrored_count = pt._frame_count
    mirrored_temporal = np.asarray(pt._temporal_state.color)
    runner.step()   # one post-mirror frame: lost on failure, by design

    pt.render_frame = _raise_runtime  # device dies
    with pytest.raises(DeviceLostError):
        runner.step()

    pt2 = _tiny_pathtracer()
    runner2 = FailoverRunner(pt2, path)
    assert runner2.resume()
    assert pt2._frame_count == mirrored_count
    np.testing.assert_array_equal(
        np.asarray(pt2._temporal_state.color), mirrored_temporal)
    # and the resumed renderer keeps rendering
    frame = runner2.step()
    assert np.isfinite(frame).all()


def _raise_runtime():
    raise _XlaRuntimeError("device gone")


def test_run_supervised_completes_and_checkpoints(tmp_path):
    path = str(tmp_path / "state.npz")
    pt = _tiny_pathtracer()
    n = run_supervised(pt, path, frames=3, mirror_every=2, timeout_s=60.0)
    assert n == 3
    assert (tmp_path / "state.npz").exists()
    # a second run resumes where the first checkpointed
    pt2 = _tiny_pathtracer()
    runner = FailoverRunner(pt2, path)
    assert runner.resume()
    assert pt2._frame_count == 3
