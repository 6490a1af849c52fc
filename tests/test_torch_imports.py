"""keystone_tpu_torch stands alone: it imports neither JAX nor the JAX
package, and its entry points never quietly fall back to the CPU."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(REPO, "keystone_tpu_torch")

_CPU_PATH = """
import os, sys
os.environ["KEYSTONE_PLAN"] = "1"
os.environ["KEYSTONE_GRAM_OP"] = "int8"
import keystone_tpu_torch
from keystone_tpu_torch import convert
from keystone_tpu_torch.models import mnist_random_fft as m
res = m.main(["--synthetic", "600", "--num-ffts", "1", "--block-size", "512"], device="cpu")
assert res["device"] == "cpu"
from keystone_tpu_torch.models import timit_pipeline as tm
for sweep in ([], ["--lam-sweep", "0.1,1"]):
    res = tm.main(["--synthetic", "200", "--num-cosines", "2", "--cosine-features", "32"] + sweep, device="cpu")
    assert res["device"] == "cpu"
from keystone_tpu_torch.core import checkpoint
from keystone_tpu_torch.evaluation import model_selection
from keystone_tpu_torch.loaders import timit
from keystone_tpu_torch.parallel import shard_batch
from keystone_tpu_torch.models.lm import TransformerLM, generate, quantize_for_decode
from keystone_tpu_torch.ops import flash_attention
from keystone_tpu_torch.serve.decode_loop import DecodeLoop
lm = TransformerLM.create(vocab=32, max_seq=24, dim=16, depth=1, num_heads=2, device="cpu")
toks = generate(quantize_for_decode(lm).replace(int8_kernel="kernel"), [[1, 2, 3]], max_new=4)
assert toks.shape == (1, 4) and toks.device.type == "cpu"
assert len(DecodeLoop(lm, slots=1, s_max=16).run([[4, 5]], max_new=3)[0]) == 3
from keystone_tpu_torch.evaluation import evaluate_perplexity
from keystone_tpu_torch.models.lm import synthetic_corpus
from keystone_tpu_torch.parallel import create_mesh
ring = TransformerLM.create(vocab=32, dim=16, depth=1, num_heads=2, pos_encoding="rope",
                            seq_mode="ring", mesh=create_mesh(devices=["cpu"] * 4), device="cpu")
ev = evaluate_perplexity(ring, synthetic_corpus(2 * 17, 32), seq=16, batch=2, logit_chunk=8)
assert ev["tokens_scored"] == 32 and ev["loss"] > 0
from keystone_tpu_torch.models import lm_transformer
from keystone_tpu_torch.models.lm import train
res = lm_transformer.main(["--steps", "2", "--batch", "2", "--seq", "8", "--dim", "16",
                           "--depth", "1", "--num-heads", "2", "--vocab", "32"], device="cpu")
assert res["steps_ran"] == 2 and res["loss_first"] > 0
_, losses = train(ring.replace(remat=True, remat_policy="dots"), synthetic_corpus(400, 32),
                  steps=1, batch=2, seq=16, logit_chunk=8)
assert len(losses) == 1 and losses[0] > 0
moe_lm = TransformerLM.create(vocab=32, max_seq=24, dim=16, depth=2, num_heads=2, moe_every=2,
                              num_experts=4, device="cpu")
toks = generate(quantize_for_decode(moe_lm).replace(int8_kernel="kernel"), [[1, 2, 3]], max_new=4)
assert toks.shape == (1, 4) and toks.device.type == "cpu"
assert len(DecodeLoop(moe_lm, slots=2, s_max=16).run([[4, 5]], max_new=3)[0]) == 3
res = lm_transformer.main(["--steps", "2", "--batch", "2", "--seq", "8", "--dim", "16",
                           "--depth", "2", "--num-heads", "2", "--vocab", "32",
                           "--moe-every", "2", "--num-experts", "4"], device="cpu")
assert res["steps_ran"] == 2 and res["loss_first"] > 0
from keystone_tpu_torch.models import cifar_linear_pixels, vit_ridge
from keystone_tpu_torch.loaders.cifar import load_cifar
from keystone_tpu_torch.ops import images, moe, vit
from keystone_tpu_torch.utils.images import LabeledImages, rgb_to_gray
res = vit_ridge.main(["--synthetic", "40", "--dim", "16", "--depth", "1", "--num-heads", "2",
                      "--chunk-size", "16"], device="cpu")
assert res["n_train"] == 40 and res["n_test"] == 8
res = cifar_linear_pixels.main(["--synthetic", "40", "--lam", "1"], device="cpu")
assert res["n_train"] == 40 and res["n_test"] == 8
from keystone_tpu_torch.core import fusion
from keystone_tpu_torch.loaders import newsgroups
from keystone_tpu_torch.models import (cifar_random, cifar_random_patch, newsgroups_pipeline,
                                       stupid_backoff_pipeline)
from keystone_tpu_torch.ops import corenlp, linalg, naive_bayes, nlp, sparse
from keystone_tpu_torch.utils.images import conv2d_separable
res = cifar_random_patch.main(["--synthetic", "40", "--num-filters", "4", "--lam", "10",
                               "--chunk-size", "16"], device="cpu")
assert res["n_train"] == 40 and res["num_features"] == 32
for plan in ("0", "1"):
    os.environ["KEYSTONE_PLAN"] = plan
    res = cifar_random.main(["--synthetic", "40", "--num-filters", "4", "--lam", "10"], device="cpu")
    assert res["n_train"] == 40 and ("fit_decisions" in res) == (plan == "1")
for extra in ([], ["--corenlp"]):
    res = newsgroups_pipeline.main(["--synthetic", "40"] + extra, device="cpu")
    assert res["n_train"] == 40 and res["vocab_size"] > 0
assert stupid_backoff_pipeline.main(["--synthetic", "40"])["num_ngrams"] > 0
from keystone_tpu_torch.evaluation import binary, mean_ap
from keystone_tpu_torch.loaders import image_loaders
from keystone_tpu_torch.models import fisher_common, voc_sift_fisher
from keystone_tpu_torch.ops import gmm, sift
from keystone_tpu_torch.resilience import retry
from keystone_tpu_torch.utils import stats
res = voc_sift_fisher.main(["--synthetic", "16", "--image-size", "32", "--sift-scales", "1",
                            "--desc-dim", "8", "--vocab-size", "2", "--num-pca-samples", "500",
                            "--num-gmm-samples", "300", "--chunk-size", "8"], device="cpu")
assert res["n_train"] == 16 and res["device"] == "cpu"
from keystone_tpu_torch.loaders import imagenet_stream, streaming
from keystone_tpu_torch.models import imagenet_sift_lcs_fv
from keystone_tpu_torch.ops import daisy, hog, lcs, weighted_linear
from keystone_tpu_torch.plan import apply_shared, shared_prefix_nodes
imnet_argv = ["--synthetic", "16", "--synthetic-classes", "2", "--image-size", "32",
              "--sift-scales", "1", "--desc-dim", "4", "--vocab-size", "2", "--lcs-border", "8",
              "--num-pca-samples", "300", "--num-gmm-samples", "200", "--chunk-size", "8",
              "--stream-batch", "8"]
for plan, extra in (("0", []), ("1", ["--streaming"])):
    os.environ["KEYSTONE_PLAN"] = plan
    res = imagenet_sift_lcs_fv.main(imnet_argv + extra, device="cpu")
    assert res["n_train"] == 16 and res["device"] == "cpu"
import numpy as np
from keystone_tpu_torch import observe, resilience
from keystone_tpu_torch.observe import events, health, schema, spans, telemetry
from keystone_tpu_torch.plan.executor import serve_stream
from keystone_tpu_torch.resilience import emit, faults, watchdog
from keystone_tpu_torch.serve import server
from keystone_tpu_torch.serve.export import export_lm, export_pipeline
app = server.build_app("mnist", {"synthetic": "200", "num_ffts": "1", "buckets": "2,4"}, device="cpu")
assert app.predict(np.zeros((5, 784), np.float32)).shape == (5,)
app.shutdown()
from keystone_tpu_torch import learn, native
from keystone_tpu_torch.core import serialization
from keystone_tpu_torch.learn import refit, shadow, swap
from keystone_tpu_torch.native import enceval
import keystone_tpu_torch.__main__
from keystone_tpu_torch.core import profiling
from keystone_tpu_torch.observe import cost, dashboard, devices, instrument, report, top, tracing
from keystone_tpu_torch.plan import cli, store, tune
app = server.build_app("lm", {"slots": "1", "s_max": "16", "max_new": "2", "vocab": "32",
                              "dim": "16", "heads": "2", "quantize": True}, device="cpu")
assert len(app.generate([1, 2])) == 2
app.shutdown()
bad = sorted(
    k for k in sys.modules
    if k.split(".")[0] == "jax" or k.startswith("jaxlib")
    or (k.split(".")[0] == "keystone_tpu")
)
print("FOREIGN", bad)
sys.exit(1 if bad else 0)
"""


def test_cpu_path_loads_no_jax_module():
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run(
        [sys.executable, "-c", _CPU_PATH],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=240,
    )
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-4000:]
    assert "FOREIGN []" in proc.stdout


def _port_sources():
    for root, _, files in os.walk(PORT_DIR):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield os.path.join(REPO, "chip_multicard.py")


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, REPO))
def test_source_imports_no_jax(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "keystone_tpu"), (path, name)


def test_default_device_raises_without_cuda():
    from keystone_tpu_torch.core.runtime import default_device, resolve_device

    if torch.cuda.is_available():
        assert default_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        default_device()
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_entry_point_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would run on it")
    from keystone_tpu_torch.models import mnist_random_fft as m

    with pytest.raises(RuntimeError, match="CUDA"):
        m.main(["--synthetic", "60", "--num-ffts", "1", "--block-size", "512"])


def test_planner_tools_without_device_raise_without_cuda():
    """The plan CLI and ``fit_shared`` take the card unless asked: with no
    CUDA, the CLI's default device raises and ``fit_shared`` requires its
    ``device``."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the tools would run on it")
    from keystone_tpu_torch import plan
    from keystone_tpu_torch.plan import cli

    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["mnist-random-fft"])
    with pytest.raises(TypeError, match="device"):
        plan.fit_shared([], torch.zeros((2, 2)))


def test_timit_entry_point_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry point would run on it")
    from keystone_tpu_torch.models import timit_pipeline as tm

    with pytest.raises(RuntimeError, match="CUDA"):
        tm.main(["--synthetic", "60", "--num-cosines", "1", "--cosine-features", "16"])


def test_lm_create_without_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the model would be made on it")
    from keystone_tpu_torch.models.lm import TransformerLM

    with pytest.raises(RuntimeError, match="CUDA"):
        TransformerLM.create(vocab=16, max_seq=8, dim=8, depth=1, num_heads=2)


def _constructors():
    import numpy as np

    from keystone_tpu_torch import convert
    from keystone_tpu_torch.models import (cifar_linear_pixels, cifar_random, cifar_random_patch,
                                           fisher_common, newsgroups_pipeline, vit_ridge,
                                           voc_sift_fisher)
    from keystone_tpu_torch.loaders import streaming
    from keystone_tpu_torch.models import imagenet_sift_lcs_fv
    from keystone_tpu_torch.models import mnist_random_fft as m
    from keystone_tpu_torch.models import timit_pipeline as tm
    from keystone_tpu_torch.ops import weighted_linear
    from keystone_tpu_torch.plan import apply_shared
    from keystone_tpu_torch.core.pipeline import Identity
    from keystone_tpu_torch.ops import gmm, linear, moe, stats, vit
    from keystone_tpu_torch.parallel import shard_batch
    from keystone_tpu_torch.serve import server
    from keystone_tpu_torch.serve.export import export_pipeline

    z = np.zeros((2, 2), np.float32)
    leaves = {"embed": z, "pos_embed": z, "blocks": []}
    return {
        "RandomSignNode.create": lambda: stats.RandomSignNode.create(4, torch.Generator()),
        "build_batch_featurizers": lambda: m.build_batch_featurizers(1, 512, 0),
        "FeaturizerBank.create": lambda: m.FeaturizerBank.create(1, 512, 0),
        "normal_eq_init": lambda: linear.normal_eq_init(3, 2),
        "fit_stats_init": lambda: linear.BlockLeastSquaresEstimator(block_size=2).fit_stats_init(3, 2),
        "convert.featurizer_bank": lambda: convert.featurizer_bank([[np.ones(4)]]),
        "convert.block_linear_mapper": lambda: convert.block_linear_mapper([z], None, None),
        "convert.normal_eq_state": lambda: convert.normal_eq_state(z, z, z[0], z[0], 1.0),
        "convert.scaled_cosine_bank": lambda: convert.scaled_cosine_bank([{"w": z, "b": z[0], "mean": z[0]}]),
        "convert.linear_mapper": lambda: convert.linear_mapper(z),
        "CosineRandomFeatures.create": lambda: stats.CosineRandomFeatures.create(4, 2, torch.Generator()),
        "timit.make_featurizers": lambda: tm.make_featurizers(tm.TimitConfig(num_cosines=1, cosine_features=2), None),
        "LinearMapEstimator.fit_stats_init": lambda: linear.LinearMapEstimator().fit_stats_init(3, 2),
        "shard_batch": lambda: shard_batch(z),
        "convert.transformer_lm": lambda: convert.transformer_lm(leaves, num_heads=1),
        "serve.export_pipeline": lambda: export_pipeline(Identity(), z, optimize=False),
        "serve.build_app": lambda: server.build_app("mnist", {"synthetic": "10"}),
        "MoELayer.create": lambda: moe.MoELayer.create(4, 8, 2),
        "convert.moe_layer": lambda: convert.moe_layer(
            {"w_router": z, "w1": z[None], "w2": z[None]}),
        "ViTFeaturizer.create": lambda: vit.ViTFeaturizer.create(dim=8, depth=1, num_heads=2),
        "convert.vit_featurizer": lambda: convert.vit_featurizer(
            {"patch_embed": z, "pos_embed": z, "blocks": []}),
        "vit_ridge.main": lambda: vit_ridge.main(["--synthetic", "10"]),
        "cifar_linear_pixels.main": lambda: cifar_linear_pixels.main(["--synthetic", "10"]),
        "cifar_random.main": lambda: cifar_random.main(["--synthetic", "10"]),
        "cifar_random_patch.main": lambda: cifar_random_patch.main(["--synthetic", "10"]),
        "cifar_random_patch.build_filters": lambda: cifar_random_patch.build_filters(
            np.zeros((2, 8, 8, 3), np.float32), cifar_random_patch.RandomCifarConfig(num_filters=1)),
        "newsgroups_pipeline.main": lambda: newsgroups_pipeline.main(["--synthetic", "10"]),
        "convert.convolver": lambda: convert.convolver(z, patch_size=1),
        "convert.fused_conv_rectify_pool": lambda: convert.fused_conv_rectify_pool(z, patch_size=1),
        "convert.zca_whitener": lambda: convert.zca_whitener(z, z[0]),
        "convert.pca_transformer": lambda: convert.pca_transformer(z),
        "convert.naive_bayes_model": lambda: convert.naive_bayes_model(z[0], z),
        "voc_sift_fisher.main": lambda: voc_sift_fisher.main(["--synthetic", "8"]),
        "FisherBranch": lambda: fisher_common.FisherBranch(2, 2, 10, 10, 0),
        "GaussianMixtureModel.load_csv": lambda: gmm.GaussianMixtureModel.load_csv("m", "v", "w"),
        "convert.gmm": lambda: convert.gmm(z, z, z[0]),
        "convert.pca_matrix": lambda: convert.pca_matrix(z),
        "imagenet_sift_lcs_fv.main": lambda: imagenet_sift_lcs_fv.main(["--synthetic", "8"]),
        "imagenet_sift_lcs_fv.run_streaming": lambda: imagenet_sift_lcs_fv.run_streaming(
            imagenet_sift_lcs_fv.ImageNetConfig(synthetic=8)),
        "weighted_eq_init": lambda: weighted_linear.weighted_eq_init(3, 2),
        "BlockWeightedLeastSquaresEstimator.fit_stats_init": lambda: (
            weighted_linear.BlockWeightedLeastSquaresEstimator().fit_stats_init(3, 2)),
        "convert.weighted_eq_state": lambda: convert.weighted_eq_state(
            z, z, z[None], z, z[0], z[0], 1.0),
        "convert.block_weighted_mapper": lambda: convert.block_weighted_mapper([z], z[0]),
        "featurize_stream": lambda: streaming.featurize_stream(iter([z]), Identity(), chunk_size=2),
        "apply_shared": lambda: apply_shared(Identity(), (Identity(),), z, chunk_size=2),
    }


@pytest.mark.parametrize("name", sorted(_constructors()))
def test_constructor_without_device_raises_without_cuda(name):
    """No public constructor of the port defaults to the CPU: without a
    device it takes the card, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the constructor would use it")
    with pytest.raises(RuntimeError, match="CUDA"):
        _constructors()[name]()


def test_state_entry_points_without_device_raise_without_cuda(tmp_path):
    """Loading a fitted pipeline or a fit state, and starting the refit
    daemon, place tensors on the card unless the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would run on it")
    from keystone_tpu_torch.core.serialization import load_fitted, save_fitted
    from keystone_tpu_torch.learn.merge import load_fit_state, save_fit_state
    from keystone_tpu_torch.learn.refit import RefitDaemon
    from keystone_tpu_torch.ops.linear import LinearMapEstimator

    path = str(tmp_path / "m.kst")
    save_fitted({"w": torch.ones(2)}, path)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_fitted(path)
    est = LinearMapEstimator()
    state = est.fit_stats_init(3, 2, "cpu")
    save_fit_state(state, str(tmp_path / "s.ksts"), est=est)
    with pytest.raises(RuntimeError, match="CUDA"):
        load_fit_state(str(tmp_path / "s.ksts"))
    with pytest.raises(RuntimeError, match="CUDA"):
        RefitDaemon(str(tmp_path / "s.ksts"), str(tmp_path))
