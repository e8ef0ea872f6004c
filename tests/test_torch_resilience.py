"""The port's retry policy, classifier and Deadline against the JAX
package's on the same errors and scripts."""

import errno
import time

import pytest

from tpu_stencil.resilience import deadline as jax_deadline
from tpu_stencil.resilience import errors as jax_errors
from tpu_stencil.resilience import retry as jax_retry

from tpu_stencil_torch.devices import NoDeviceError
from tpu_stencil_torch.ops._build import KernelBuildError
from tpu_stencil_torch.ops.cuda_stencil import KernelLaunchError
from tpu_stencil_torch.resilience import deadline, errors, retry

SHARED = [
    (NotImplementedError("no"), "permanent"),
    (ValueError("bad shape"), "permanent"),
    (TypeError("bad type"), "permanent"),
    (KeyError("k"), "permanent"),
    (ZeroDivisionError("z"), "permanent"),
    (RuntimeError("RESOURCE_EXHAUSTED: out of memory"), "transient"),
    (RuntimeError("CUDA out of memory"), "transient"),
    (RuntimeError("UNAVAILABLE: connection reset"), "transient"),
    (RuntimeError("INVALID_ARGUMENT: nope"), "permanent"),
    (RuntimeError("something odd"), "transient"),
    (OSError(errno.ENOENT, "missing"), "permanent"),
    (OSError(errno.EIO, "flaky disk"), "transient"),
    (FileNotFoundError(errno.ENOENT, "missing"), "permanent"),
]


@pytest.mark.parametrize("exc,want", SHARED,
                         ids=[type(e).__name__ + str(i)
                              for i, (e, _) in enumerate(SHARED)])
def test_classifier_agrees_with_the_jax_packages(exc, want):
    assert retry.classify(exc) == want == jax_retry.classify(exc)
    assert retry.is_transient(exc) == (want == "transient")


def test_typed_errors_classify_as_in_the_jax_package():
    # An expired request can only expire again, whatever its message.
    for msg in ("x", "UNAVAILABLE: try again"):
        assert retry.classify(errors.DeadlineExceeded(msg)) == "permanent"
        assert jax_retry.classify(
            jax_errors.DeadlineExceeded(msg)) == "permanent"
    assert issubclass(errors.DeadlineExceeded, errors.ResilienceError)
    assert issubclass(errors.ResilienceError, RuntimeError)


def test_a_kernel_that_does_not_build_or_launch_is_permanent():
    # The same sources and arguments fail the same way: never retried,
    # whatever the message says.
    for exc in (KernelBuildError("nvcc exited 1: out of memory"),
                KernelLaunchError("cudaError_t 1 (UNAVAILABLE)"),
                NoDeviceError("no CUDA device")):
        assert retry.classify(exc) == "permanent"
    calls = []

    def build():
        calls.append(1)
        raise KernelBuildError("nvcc not found")

    with pytest.raises(KernelBuildError):
        retry.retry_call(build, policy=retry.RetryPolicy(attempts=5,
                                                         base_delay=0.0))
    assert calls == [1]


def test_retry_call_retries_transient_then_raises_the_last():
    for mod in (retry, jax_retry):
        calls, seen = [], []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise RuntimeError("UNAVAILABLE: try again")
            return "ok"

        policy = mod.RetryPolicy(attempts=3, base_delay=0.0, jitter=0.0)
        assert mod.retry_call(flaky, policy=policy,
                              on_retry=lambda a, e: seen.append(a)) == "ok"
        assert len(calls) == 3 and seen == [0, 1]
        calls.clear()
        with pytest.raises(RuntimeError, match="try again"):
            mod.retry_call(flaky, policy=mod.RetryPolicy(
                attempts=2, base_delay=0.0, jitter=0.0))
        assert len(calls) == 2


def test_retry_counts_its_retries_and_backs_off():
    before = retry.retries_total
    calls = []

    def fn():
        calls.append(time.perf_counter())
        if len(calls) == 1:
            raise RuntimeError("UNAVAILABLE")
        return 7

    assert retry.retry_call(fn, policy=retry.RetryPolicy(
        attempts=2, base_delay=0.05, jitter=0.0)) == 7
    assert calls[1] - calls[0] >= 0.045  # the policy's delay was slept
    assert retry.retries_total == before + 1


def test_policy_delays_match():
    a = retry.RetryPolicy(attempts=4, base_delay=0.5, multiplier=2.0,
                          max_delay=3.0, jitter=0.0)
    b = jax_retry.RetryPolicy(attempts=4, base_delay=0.5, multiplier=2.0,
                              max_delay=3.0, jitter=0.0)
    assert [a.delay(k) for k in range(5)] == [b.delay(k) for k in range(5)]
    assert a.delay(4) == 3.0
    j = retry.RetryPolicy(base_delay=1.0, jitter=0.1)
    assert all(0.9 <= j.delay(0) <= 1.1 for _ in range(50))


def test_an_on_retry_hook_imposes_a_deadline():
    # A hook that raises aborts the loop with its own error: how a caller
    # bounds the whole retry loop with a Deadline.
    budget = deadline.Deadline.after(-1.0)
    calls = []

    def busy():
        calls.append(1)
        raise RuntimeError("UNAVAILABLE")

    def on_retry(_attempt, exc):
        if budget.expired():
            raise errors.DeadlineExceeded("gave up") from exc

    with pytest.raises(errors.DeadlineExceeded, match="gave up"):
        retry.retry_call(busy, policy=retry.RetryPolicy(
            attempts=100, base_delay=0.0), on_retry=on_retry)
    assert calls == [1]


def test_deadline():
    for mod in (deadline, jax_deadline):
        d = mod.Deadline.after(30.0)
        assert not d.expired() and 29.0 < d.remaining() <= 30.0
        gone = mod.Deadline.after(-1.0)
        assert gone.expired() and gone.remaining() < 0


# -- the dispatch watchdog ------------------------------------------------


class _Hang:
    """A stub whose drain hangs until released (a wedged device)."""

    def __init__(self):
        import threading

        self.release = threading.Event()

    def synchronize(self):
        self.release.wait(30)


def test_fence_passthrough_without_timeout():
    import torch

    t = torch.zeros(3)
    assert deadline.fence(t, 0) is t
    grid = [[t, t], [t, t]]
    assert deadline.fence(grid, 5.0, "grid") is grid


def test_fence_converts_hang_to_typed_timeout():
    from tpu_stencil_torch import obs

    obs.reset()
    stub = _Hang()
    t0 = time.perf_counter()
    with pytest.raises(errors.DispatchTimeout) as e:
        deadline.fence(stub, 0.2, "driver.iterate[rep=0]")
    assert time.perf_counter() - t0 < 5.0
    assert (e.value.label, e.value.seconds) == ("driver.iterate[rep=0]", 0.2)
    jax_msg = str(jax_errors.DispatchTimeout("driver.iterate[rep=0]", 0.2))
    assert str(e.value).split(" watchdog")[0] == jax_msg.split(" watchdog")[0]
    assert obs.snapshot()["counters"][
        "resilience_dispatch_timeouts_total"] == 1
    stub.release.set()
    obs.reset()


def test_fence_surfaces_drain_error():
    class Broken:
        def synchronize(self):
            raise RuntimeError("device lost")

    with pytest.raises(RuntimeError, match="device lost"):
        deadline.fence(Broken(), 1.0)


def test_env_default_timeout_and_resolve(monkeypatch):
    monkeypatch.setenv(deadline.ENV_VAR, "2.5")
    assert deadline.ENV_VAR == "TPU_STENCIL_TORCH_DISPATCH_TIMEOUT"
    assert deadline.default_timeout() == 2.5
    assert deadline.resolve(0.0) == 2.5 and deadline.resolve(7.0) == 7.0
    monkeypatch.setenv(deadline.ENV_VAR, "junk")
    assert deadline.default_timeout() == 0.0
    for mod in (deadline, jax_deadline):
        monkeypatch.delenv(mod.ENV_VAR, raising=False)
        assert mod.resolve(None) == 0.0 and mod.resolve(3.0) == 3.0


def test_run_job_passes_the_dispatch_timeout(tmp_path, monkeypatch):
    import numpy as np
    import torch

    from tpu_stencil_torch import config as tconfig
    from tpu_stencil_torch import driver as tdriver

    seen = []
    real = deadline.fence

    def spy(x, timeout_s=None, label="dispatch"):
        seen.append((timeout_s, label))
        return real(x, timeout_s, label)

    monkeypatch.setattr(deadline, "fence", spy)
    src = tmp_path / "in.raw"
    np.zeros((8, 6), np.uint8).tofile(src)
    cfg, _ = tconfig.parse_args([str(src), "6", "8", "4", "grey",
                                 "--dispatch-timeout", "9.5",
                                 "--output", str(tmp_path / "o.raw")])
    assert cfg.dispatch_timeout_s == 9.5
    tdriver.run_job(cfg, devices=[torch.device("cpu")], checkpoint_every=2)
    # The warm-up drains under the watchdog too, so the drain thread has
    # started (and made its first CUDA call) before the window opens.
    assert seen == [(9.5, "driver.warmup"),
                    (9.5, "driver.iterate[rep=0]"),
                    (9.5, "driver.iterate[rep=2]")]
    with pytest.raises(SystemExit):
        tconfig.parse_args([str(src), "6", "8", "4", "grey",
                            "--dispatch-timeout", "-1"])


def test_sharded_run_job_passes_the_dispatch_timeout(tmp_path, monkeypatch):
    import numpy as np
    import torch

    from tpu_stencil_torch import config as tconfig
    from tpu_stencil_torch import driver as tdriver

    seen = []
    real = deadline.fence

    def spy(x, timeout_s=None, label="dispatch"):
        seen.append((timeout_s, label))
        return real(x, timeout_s, label)

    monkeypatch.setattr(deadline, "fence", spy)
    src = tmp_path / "in.raw"
    np.arange(16 * 12, dtype=np.uint8).reshape(16, 12).tofile(src)
    cfg, _ = tconfig.parse_args([str(src), "12", "16", "3", "grey",
                                 "--mesh", "2x2", "--dispatch-timeout", "4",
                                 "--output", str(tmp_path / "o.raw")])
    tdriver.run_job(cfg, devices=[torch.device("cpu")] * 4)
    assert seen == [(4.0, "sharded.warmup"), (4.0, "driver.iterate[rep=0]")]


def test_fence_reuses_one_drain_thread_until_a_drain_hangs(monkeypatch):
    import threading

    import torch

    from tpu_stencil_torch import obs

    threads = []
    real = deadline._drain

    def spy(x):
        threads.append(threading.get_ident())
        return real(x)

    monkeypatch.setattr(deadline, "_drain", spy)
    t = torch.zeros(3)
    for _ in range(3):
        assert deadline.fence(t, 5.0, "reuse") is t
    assert len(set(threads)) == 1
    assert threads[0] != threading.get_ident()
    obs.reset()
    stub = _Hang()
    with pytest.raises(errors.DispatchTimeout):
        deadline.fence(stub, 0.2, "hang")
    # The hung thread is abandoned; the next fence drains on a new one.
    assert deadline.fence(t, 5.0, "after") is t
    assert threads[-1] not in threads[:3]
    stub.release.set()
    obs.reset()
