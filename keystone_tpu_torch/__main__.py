"""Pipeline launcher: ``python -m keystone_tpu_torch <pipeline> [args...]``.

Port of ``keystone_tpu/__main__.py``: dispatches to a model's ``main`` by
short name or by reference-style class name, or to a subcommand's
``main``. Every entry point runs on the card unless its arguments ask for
the CPU (``--device cpu``); each module keeps its own ``-m`` entry too.
``--profile DIR`` traces the whole pipeline with ``torch.profiler``
(:func:`keystone_tpu_torch.core.profiling.trace`, ``DIR/trace.json``);
``--observe DIR`` (or ``KEYSTONE_OBSERVE_DIR``) brackets it with a run
event log that ``observe <dir>`` renders. ``--multihost`` waits for the
multi-process slice (ROADMAP A6).
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
    if "--multihost" in argv:
        raise SystemExit(
            "--multihost: multi-process runs wait for the multi-card slice (ROADMAP A6)"
        )
    profile_dir = _take_flag(argv, "--profile")
    observe_dir = _take_flag(argv, "--observe")
    if not argv or argv[0] in ("-h", "--help"):
        names = "\n  ".join(sorted(PIPELINES))
        commands = "\n  ".join(sorted(COMMANDS))
        raise SystemExit(
            "usage: python -m keystone_tpu_torch [--profile DIR] [--observe DIR] "
            "<pipeline> [args...]\n"
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

    def dispatch():
        if profile_dir is not None:
            from keystone_tpu_torch.core.profiling import trace

            with trace(profile_dir):
                return entry(rest)
        return entry(rest)

    if observe_dir is None:
        import os

        observe_dir = os.environ.get("KEYSTONE_OBSERVE_DIR") or None
    if observe_dir is not None:
        # the launcher brackets the whole pipeline with run_start/run_end
        # so the report knows total wall and status
        from keystone_tpu_torch.observe import events

        with events.run(observe_dir, pipeline=name, argv=rest):
            dispatch()
    else:
        dispatch()


if __name__ == "__main__":
    main()
