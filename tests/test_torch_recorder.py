"""The port recorder's crash hooks (``forensics/recorder.py``: the JAX
recorder's ``install_signal_handlers``, ``install_excepthook``,
``install_faulthandler`` and ``install()``), each in a child process of
its own: SIGUSR2 writes a bundle and the process runs on, SIGTERM writes
one and the process dies of the signal, an unhandled exception writes a
``crash-ValueError`` bundle and still prints its traceback, and
faulthandler writes its log beside the bundles.  ``install()`` arms them
all without the JAX recorder's ``jax.monitoring`` listener."""

import os
import signal
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def child(tmp_path, body):
    code = textwrap.dedent(f"""
        import os, signal, sys, time
        from lodestar_tpu_torch.forensics import RECORDER
        RECORDER.configure(forensics_dir={str(tmp_path)!r})
    """) + textwrap.dedent(body)
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def bundles(tmp_path, word):
    return sorted(d for d in os.listdir(tmp_path) if d.startswith("bundle-") and word in d)


def test_sigusr2_dumps_and_the_process_runs_on(tmp_path):
    proc = child(tmp_path, """
        RECORDER.install_signal_handlers(signals=(signal.SIGUSR2,))
        os.kill(os.getpid(), signal.SIGUSR2)
        time.sleep(0.2)
        print("still here", RECORDER.bundles_written)
        RECORDER.uninstall_signal_handlers()
        assert signal.getsignal(signal.SIGUSR2) is signal.SIG_DFL
    """)
    assert proc.returncode == 0, proc.stderr
    assert "still here 1" in proc.stdout
    assert len(bundles(tmp_path, "sigusr2")) == 1


def test_sigterm_dumps_then_the_process_dies_of_it(tmp_path):
    proc = child(tmp_path, """
        RECORDER.install_signal_handlers()
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(5)
        print("survived")
    """)
    assert proc.returncode == -signal.SIGTERM
    assert "survived" not in proc.stdout
    assert len(bundles(tmp_path, "sigterm")) == 1


def test_an_unhandled_exception_writes_a_crash_bundle(tmp_path):
    proc = child(tmp_path, """
        RECORDER.install_excepthook()
        raise ValueError("boom")
    """)
    assert proc.returncode == 1
    assert "ValueError: boom" in proc.stderr  # the previous hook still ran
    (bundle,) = bundles(tmp_path, "crash-ValueError")
    with open(os.path.join(tmp_path, bundle, "journal.jsonl")) as f:
        assert '"crash"' in f.read()


def test_install_arms_the_hooks_and_faulthandler_writes_its_log(tmp_path):
    proc = child(tmp_path, """
        import faulthandler, sys
        RECORDER.install(watchdog_deadline_s=5.0)
        assert RECORDER.watchdog is not None
        assert faulthandler.is_enabled()
        assert sys.excepthook is not sys.__excepthook__
        assert callable(signal.getsignal(signal.SIGUSR2))
        assert not any(m.split(".")[0] in ("jax", "lodestar_tpu") for m in sys.modules)
        RECORDER.stop_watchdog()
        faulthandler.dump_traceback(file=RECORDER._faulthandler_file)
        RECORDER._faulthandler_file.flush()
        print("installed")
    """)
    assert proc.returncode == 0, proc.stderr
    assert "installed" in proc.stdout
    with open(os.path.join(tmp_path, "faulthandler.log")) as f:
        assert "most recent call first" in f.read()
