"""Pipeline launcher: ``python -m keystone_tpu_torch <pipeline> [args...]``.

Port of ``keystone_tpu/__main__.py``: dispatches to a model's ``main`` by
short name or by reference-style class name, or to a subcommand's
``main``. Every entry point runs on the card unless its arguments ask for
the CPU (``--device cpu``); each module keeps its own ``-m`` entry too.
``--profile DIR`` traces the whole pipeline with ``torch.profiler``
(:func:`keystone_tpu_torch.core.profiling.trace`, ``DIR/trace.json``);
``--observe DIR`` (or ``KEYSTONE_OBSERVE_DIR``) brackets it with a run
event log that ``observe <dir>`` renders. ``--multihost`` joins the
process group first (:func:`keystone_tpu_torch.parallel.multihost.initialize`,
wired by the supervisor's environment), starts the cluster monitor, runs
the pipeline data-parallel, and rolls every process's metrics up into
``metrics_cluster.json`` (on process 0) when it returns::

    python -m keystone_tpu_torch supervise --procs 2 -- \
        python -m keystone_tpu_torch --multihost mnist-random-fft --synthetic 60000
"""

from __future__ import annotations

import sys

# short name → (module, reference class name)
PIPELINES = {
    "mnist-random-fft": (
        "keystone_tpu_torch.models.mnist_random_fft",
        "pipelines.images.mnist.MnistRandomFFT",
    ),
    "cifar-linear-pixels": (
        "keystone_tpu_torch.models.cifar_linear_pixels",
        "pipelines.images.cifar.LinearPixels",
    ),
    "cifar-random-patch": (
        "keystone_tpu_torch.models.cifar_random_patch",
        "pipelines.images.cifar.RandomPatchCifar",
    ),
    "cifar-random": (
        "keystone_tpu_torch.models.cifar_random",
        "pipelines.images.cifar.RandomCifar",
    ),
    "voc-sift-fisher": (
        "keystone_tpu_torch.models.voc_sift_fisher",
        "pipelines.images.voc.VOCSIFTFisher",
    ),
    "imagenet-sift-lcs-fv": (
        "keystone_tpu_torch.models.imagenet_sift_lcs_fv",
        "pipelines.images.imagenet.ImageNetSiftLcsFV",
    ),
    "timit": (
        "keystone_tpu_torch.models.timit_pipeline",
        "pipelines.speech.TimitPipeline",
    ),
    "newsgroups": (
        "keystone_tpu_torch.models.newsgroups_pipeline",
        "pipelines.text.NewsgroupsPipeline",
    ),
    "stupid-backoff": (
        "keystone_tpu_torch.models.stupid_backoff_pipeline",
        "pipelines.nlp.StupidBackoffPipeline",
    ),
    "vit-ridge": ("keystone_tpu_torch.models.vit_ridge", None),
    "lm-transformer": ("keystone_tpu_torch.models.lm_transformer", None),
}

# non-pipeline subcommands: short name → module whose ``main(argv)`` runs
COMMANDS = {
    "observe": "keystone_tpu_torch.observe.report",
    "faults": "keystone_tpu_torch.resilience.faults",
    "plan": "keystone_tpu_torch.plan.cli",
    "supervise": "keystone_tpu_torch.resilience.supervisor",
    "serve": "keystone_tpu_torch.serve.server",
    "fleet": "keystone_tpu_torch.serve.fleet",
    "refit": "keystone_tpu_torch.learn.refit",
    "chaos": "keystone_tpu_torch.resilience.chaos",
}


def _take_flag(argv: list[str], flag: str) -> str | None:
    """Remove ``flag VALUE`` from ``argv`` and return VALUE (or None)."""
    if flag not in argv:
        return None
    i = argv.index(flag)
    if i + 1 >= len(argv):
        raise SystemExit(f"{flag} needs a directory argument")
    value = argv[i + 1]
    del argv[i : i + 2]
    return value


def main(argv: list[str] | None = None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    # the launcher's own flags stop at a "--": what follows is another
    # command's (supervise -- python -m keystone_tpu_torch --multihost ...)
    cut = argv.index("--") if "--" in argv else len(argv)
    head, tail = argv[:cut], argv[cut:]
    multihost = "--multihost" in head
    if multihost:
        head.remove("--multihost")
    profile_dir = _take_flag(head, "--profile")
    observe_dir = _take_flag(head, "--observe")
    argv = head + tail
    if not argv or argv[0] in ("-h", "--help"):
        names = "\n  ".join(sorted(PIPELINES))
        commands = "\n  ".join(sorted(COMMANDS))
        raise SystemExit(
            "usage: python -m keystone_tpu_torch [--multihost] [--profile DIR] "
            "[--observe DIR] <pipeline> [args...]\n"
            f"pipelines:\n  {names}\n"
            f"commands:\n  {commands}\n"
            "(reference class names like pipelines.images.mnist.MnistRandomFFT are\n"
            " also accepted; a pipeline runs on the card unless given --device cpu;\n"
            " --profile DIR writes a torch.profiler trace to DIR/trace.json;\n"
            " --observe DIR writes a per-run event log there, rendered by\n"
            " `observe <dir>`, tailed live by `observe top <dir>` and compared\n"
            " across runs by `observe diff <dirA> <dirB>`; `plan <model>` prints\n"
            " the cost-based planner's plan for the card (`--learned` shows the\n"
            " KEYSTONE_PLAN_STORE record instead); `faults --list` prints the\n"
            " KEYSTONE_FAULTS sites; `serve`, `fleet`, `refit`, `supervise` and\n"
            " `chaos` each take --help)"
        )
    import importlib

    if argv[0] in COMMANDS:
        return importlib.import_module(COMMANDS[argv[0]]).main(argv[1:])
    name, rest = argv[0], argv[1:]
    target = None
    if name in PIPELINES:
        target = PIPELINES[name][0]
    else:
        for mod, ref in PIPELINES.values():
            if ref == name:
                target = mod
                break
    if target is None:
        raise SystemExit(f"unknown pipeline {name!r}; run with --help for a list")
    entry = importlib.import_module(target).main
    if multihost:
        from keystone_tpu_torch.parallel import multihost as mh
        from keystone_tpu_torch.resilience import cluster as _cluster

        mh.initialize()
        # membership heartbeats and failure detection for the whole run: a
        # lost process becomes a clean EXIT_HOST_LOST exit that `supervise`
        # relaunches, not a silent collective hang
        _cluster.start_monitor()

    def dispatch():
        if profile_dir is not None:
            from keystone_tpu_torch.core.profiling import trace

            with trace(profile_dir):
                return entry(rest)
        return entry(rest)

    if observe_dir is None:
        import os

        observe_dir = os.environ.get("KEYSTONE_OBSERVE_DIR") or None
    def rollup(run_dir):
        # every process calls it (it meets at a barrier); process 0 merges
        # the cluster totals into the run dir. Never fatal; skipped after a
        # host loss, whose barrier would only time out on the dead peer.
        if not multihost:
            return
        from keystone_tpu_torch.parallel import multihost as mh
        from keystone_tpu_torch.resilience import cluster as _cluster

        if _cluster.check_lost() is not None:
            return
        try:
            mh.rollup_metrics(run_dir)
        except Exception as e:  # noqa: BLE001
            print(f"# multihost metrics roll-up failed: {e!r}", file=sys.stderr)

    try:
        if observe_dir is not None:
            # the launcher brackets the whole pipeline with run_start/run_end
            # so the report knows total wall and status
            from keystone_tpu_torch.observe import events

            with events.run(observe_dir, pipeline=name, argv=rest) as log:
                dispatch()
                rollup(getattr(log, "run_dir", observe_dir))
        else:
            dispatch()
            rollup(None)
    except Exception as e:
        if multihost:
            from keystone_tpu_torch.resilience import cluster as _cluster

            if isinstance(e, _cluster.ClusterError):
                # the supervisor's exit-code protocol: a host loss is a
                # re-mesh request, not a crash
                print(f"# host loss: {e}", file=sys.stderr)
                raise SystemExit(_cluster.EXIT_HOST_LOST) from e
        raise
    finally:
        if multihost:
            from keystone_tpu_torch.parallel import multihost as mh
            from keystone_tpu_torch.resilience import cluster as _cluster

            _cluster.stop_monitor()
            mh.shutdown()


if __name__ == "__main__":
    main()
