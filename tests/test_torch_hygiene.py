"""The port stands alone: no JAX, nothing of paddle_tpu, no CPU fallback.

``paddle_tpu_torch`` starts with the string ``paddle_tpu``, so every check
here tells the two packages apart by the full module name.
"""

import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.models import (
    bert, deepfm, resnet, se_resnext, transformer, vgg,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "paddle_tpu_torch")

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|paddle_tpu)(?:\.|\s|$)"
    r"|(?:import_module|__import__)\(\s*['\"](?:jax|jaxlib|paddle_tpu)"
    r"(?:\.|['\"])", re.M)


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PORT):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_forbidden_pattern_tells_the_packages_apart():
    assert _FORBIDDEN.search("import jax\n")
    assert _FORBIDDEN.search("from paddle_tpu.ops import nn\n")
    assert _FORBIDDEN.search("import paddle_tpu\n")
    assert _FORBIDDEN.search("x = importlib.import_module('jax')\n")
    assert not _FORBIDDEN.search("import paddle_tpu_torch\n")
    assert not _FORBIDDEN.search("from paddle_tpu_torch.ops import kernels\n")


def test_port_sources_import_no_jax_and_no_paddle_tpu():
    srcs = _port_sources()
    assert len(srcs) >= 10
    # the subpackages with copies of jax-free JAX-package modules are
    # scanned too
    for sub in ("serving", "monitor", "static", "models", "layers",
                "distributed", "nn", "dataio"):
        assert any(f"{os.sep}{sub}{os.sep}" in p for p in srcs), sub
    for mod in ("nets.py", "optimizer.py", f"ops{os.sep}nn.py",
                "lod_tensor.py", f"core{os.sep}lod.py",
                f"ops{os.sep}sequence.py", f"ops{os.sep}crf.py",
                f"ops{os.sep}rnn.py", f"nn{os.sep}module.py",
                f"ops{os.sep}control_flow.py", f"ops{os.sep}tensor_array.py",
                f"static{os.sep}nested.py", f"static{os.sep}debugger.py",
                f"layers{os.sep}io.py",
                f"layers{os.sep}control_flow_classes.py", "reader.py",
                f"dataio{os.sep}feeder.py", f"dataio{os.sep}pyreader.py",
                "backward.py", f"models{os.sep}ptb_lm.py",
                f"ops{os.sep}detection.py", f"models{os.sep}ssd.py",
                f"models{os.sep}yolov3.py"):
        assert any(p.endswith(f"{os.sep}{mod}") for p in srcs), mod
    for path in srcs:
        with open(path) as f:
            m = _FORBIDDEN.search(f.read())
        assert m is None, f"{path}: {m.group(0)!r}"


def test_importing_the_port_loads_no_jax_and_no_paddle_tpu():
    code = (
        "import sys\n"
        "import paddle_tpu_torch, paddle_tpu_torch.ops.kernels\n"
        "import paddle_tpu_torch.models.bert, paddle_tpu_torch.optimizer\n"
        "import paddle_tpu_torch.inference, paddle_tpu_torch.serving\n"
        "import paddle_tpu_torch.monitor.trace, paddle_tpu_torch.io\n"
        "import paddle_tpu_torch.models.resnet, paddle_tpu_torch.models.vgg\n"
        "import paddle_tpu_torch.models.se_resnext, paddle_tpu_torch.clip\n"
        "import paddle_tpu_torch.regularizer\n"
        "import paddle_tpu_torch.models.transformer\n"
        "import paddle_tpu_torch.models.deepfm, paddle_tpu_torch.distributed\n"
        "import paddle_tpu_torch.layers.learning_rate_scheduler\n"
        "import paddle_tpu_torch.nets, paddle_tpu_torch.nn\n"
        "import paddle_tpu_torch.nn.module, paddle_tpu_torch.lod_tensor\n"
        "import paddle_tpu_torch.core.lod, paddle_tpu_torch.ops.sequence\n"
        "import paddle_tpu_torch.ops.crf, paddle_tpu_torch.ops.rnn\n"
        "import paddle_tpu_torch.ops.control_flow\n"
        "import paddle_tpu_torch.ops.tensor_array\n"
        "import paddle_tpu_torch.static.nested\n"
        "import paddle_tpu_torch.static.debugger\n"
        "import paddle_tpu_torch.layers.io\n"
        "import paddle_tpu_torch.layers.control_flow_classes\n"
        "import paddle_tpu_torch.reader, paddle_tpu_torch.dataio\n"
        "import paddle_tpu_torch.dataio.feeder\n"
        "import paddle_tpu_torch.dataio.pyreader\n"
        "import paddle_tpu_torch.backward\n"
        "import paddle_tpu_torch.models.ptb_lm\n"
        "import paddle_tpu_torch.ops.detection\n"
        "import paddle_tpu_torch.models.ssd, paddle_tpu_torch.models.yolov3\n"
        "sys.path.insert(0, '.')\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'paddle_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.strip() == "[]"


def leaves_device(tree):
    from paddle_tpu_torch.core.tree import leaves
    return {t.device for t in leaves(tree)}


def _run_chip_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_without_a_card_fails_with_a_message():
    r = _run_chip_smoke(REPO)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_chip_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError,
                       match="no CUDA device"):
        paddle_tpu_torch.default_device()
    cfg = bert.bert_tiny()
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        bert.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        bert.params_from_numpy({}, cfg)
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        bert.make_train_step(cfg, optimizer.Adam())
    assert paddle_tpu_torch.resolve_device("cpu") == torch.device("cpu")
    for model, vcfg in ((resnet, resnet.resnet_cifar10(depth=8)),
                        (vgg, vgg.vgg11(num_classes=10, image_size=32)),
                        (se_resnext, se_resnext.se_resnext_tiny())):
        with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
            model.init_params(vcfg, torch.Generator().manual_seed(0))
        with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
            model.make_train_step(vcfg, optimizer.Momentum(0.1))
    tcfg = transformer.transformer_tiny()
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        transformer.init_params(tcfg, torch.Generator().manual_seed(0))
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        transformer.params_from_numpy({}, tcfg)
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        transformer.make_train_step(tcfg, optimizer.Adam())
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        deepfm.CTRTrainer(deepfm.DeepFMConfig(num_slots=2))
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        deepfm.init_dense_params(deepfm.DeepFMConfig(),
                                 torch.Generator().manual_seed(0))
    assert deepfm.CTRTrainer(deepfm.DeepFMConfig(num_slots=2),
                             device="cpu").params["w0"].device == \
        torch.device("cpu")
    # the book models' path: the Executor asks for the card; the ops,
    # nets and the rules without a kernel stay on their tensors' device
    main, startup = paddle_tpu_torch.Program(), paddle_tpu_torch.Program()
    with paddle_tpu_torch.program_guard(main, startup):
        img = paddle_tpu_torch.data("img", [1, 12, 12])
        out = paddle_tpu_torch.nets.simple_img_conv_pool(
            img, num_filters=2, filter_size=3, pool_size=2, pool_stride=2)
        optimizer.Adagrad(0.1).minimize(paddle_tpu_torch.layers.mean(
            paddle_tpu_torch.layers.batch_norm(out)))
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        paddle_tpu_torch.Executor()
    p = {"w": torch.ones(3)}
    for opt in (optimizer.Lamb(), optimizer.ExponentialMovingAverage()):
        state = opt.init(p)
        assert leaves_device(state) == {torch.device("cpu")}
    # the sequence models' entry points: ragged batches, the lod tensors,
    # the JAX weights and the module context's parameters go to the card
    from paddle_tpu_torch.core.lod import RaggedBatch
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        RaggedBatch.from_list([[1, 2], [3]])
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        paddle_tpu_torch.create_random_int_lodtensor([[2, 1]], [1])
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        paddle_tpu_torch.nn.params_from_numpy({"w": np.zeros(2)})
    model = paddle_tpu_torch.nn.transform(
        lambda x: paddle_tpu_torch.layers.fc(x, 2))
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        model.init(None, torch.ones(1, 3))
    params, _ = model.init(torch.Generator().manual_seed(0),
                           torch.ones(1, 3))
    assert leaves_device(params) == {torch.device("cpu")}
    init_fn, _ = bert.make_train_step(cfg, optimizer.Adam(), device="cpu")
    params, state = init_fn(torch.Generator().manual_seed(0))
    assert state["step"].device == params["embed"]["word"].device == \
        torch.device("cpu")
    # the control-flow slice: the Executor, the reader's staging, the
    # DataFeeder and the ops that make a tensor from nothing ask for the
    # card; tensor arrays and the eager loops stay on their tensors' device
    from paddle_tpu_torch.dataio import DataFeeder, PyReader
    from paddle_tpu_torch.models import ptb_lm
    from paddle_tpu_torch.ops import tensor_array
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        paddle_tpu_torch.Executor()
    lm = ptb_lm.build_train(paddle_tpu_torch, ptb_lm.lm_tiny())
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        lm["reader"].decorate_tensor_provider(lambda: iter([]))
        iter(lm["reader"])
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        PyReader(capacity=2).decorate_batch_generator(lambda: iter([]))
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        DataFeeder(["x"])
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        paddle_tpu_torch.ops.fill_constant([2], "float32", 1.0)
    with pytest.raises(paddle_tpu_torch.NoCudaDeviceError):
        tensor_array.create_array(2, (3,))
    arr = tensor_array.create_array(2, (3,), device="cpu")
    assert arr.write(0, torch.ones(3)).buffer.device == torch.device("cpu")
    i, = paddle_tpu_torch.ops.while_loop(lambda i: i < 3, lambda i: [i + 1],
                                         [torch.tensor(0)])
    assert i.device == torch.device("cpu")
