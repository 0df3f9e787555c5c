"""CycleGAN as three Fluid static programs: the two generators' training
program (G), the two discriminators' (D_A, D_B), and, cloned from G's
network before its losses, the inference program (both generators).

Source: PaddlePaddle/models (Fluid 1.5 era), ``PaddleCV/PaddleGAN``:
``network/base_network.py`` (``conv2d``, ``deconv2d``, ``norm_layer``),
``network/CycleGAN_network.py`` (``build_generator_resnet_9blocks``,
``build_gen_discriminator``) and ``trainer/CycleGAN.py`` (``GTrainer``,
``DATrainer``, ``DBTrainer``, ``ImagePool``, the training loop).
:func:`cyclegan_256` is its published configuration: 256^2 images, batch 1,
32 generator and 64 discriminator base channels, 9 residual blocks, Adam at
2e-4 with beta1 0.5, cycle weights 10 and identity weight 0.5.

- **Generator**: reflect ``pad2d`` 3, conv 7x7 to ngf; conv 3x3/2 pad 1 to
  2 ngf, then to 4 ngf; ``n_blocks`` residual blocks at 4 ngf (reflect pad
  1, conv 3x3, instance norm, ReLU, reflect pad 1, conv 3x3, instance norm,
  then the input added); two ``conv2d_transpose`` 3x3/2 pad 1 (to 2 ngf,
  then ngf), each followed by a constant ``pad2d`` [0, 1, 0, 1] (so 64^2
  becomes 127^2, then 128^2), instance norm and ReLU; reflect pad 3, conv
  7x7 to 3 with a bias, ``tanh``.
- **Discriminator**: a 70x70 PatchGAN of 4x4 convs with padding 1: c1 ndf/2
  with a bias and no norm, c2 2 ndf/2, c3 4 ndf/2, c4 8 ndf/1, each of
  c2-c4 with instance norm and no bias, ``leaky_relu(0.2)`` after c1-c4,
  then c5 1/1 with a bias and no activation: a 30x30 patch map at 256^2.
- **Instance norm** is ``layers.instance_norm`` over a per-channel scale
  (``TruncatedNormal(1.0, 0.02)``) and offset (``Constant(0)``) made by
  ``layers.create_parameter``. ``base_network.py`` writes the same
  statistics out by hand (``reduce_mean`` of x and of the squared
  deviations, ``sqrt(var + 1e-5)``); the op computes them in one place.
- The conv weights are ``Normal(0, 0.02)``, their biases ``Constant(0)``.

Where this module departs from the source:

- the parameters are named ``g_A_*``, ``g_B_*``, ``d_A_*`` and ``d_B_*``
  (the source's ``GA``, ``GB``, ``DA``, ``DB``), so that the three programs
  share them through one scope; as in the source, ``d_A`` judges domain B
  (``fake_B`` and ``input_B``) and ``d_B`` domain A;
- the weighted losses are ``layers.scale`` ops where the source multiplies
  a Variable by a float (the cycle and identity weights as one factor
  each: 10 and 10 x 0.5), and ``x - 1`` is ``scale(x, bias=-1)``;
- the images are synthetic (:func:`synthetic_images`), seeded, in [-1, 1];
- the pool draws from ``numpy.random.RandomState(seed)``, where the source
  calls Python's ``random``;
- the learning rate stays constant (the source decays it linearly after
  epoch 100, which no run here reaches).

The programs are built with whichever package is passed as ``pt`` (this
one, or the JAX package, whose layers take the same calls), so the two
build the same documents. :func:`cyclegan_tiny` is the CPU tests' config.
"""

import dataclasses

import numpy as np

__all__ = ["CycleGANConfig", "cyclegan_256", "cyclegan_tiny",
           "build_generator_resnet_9blocks", "build_gen_discriminator",
           "build_train", "ImagePool", "synthetic_images", "train_iteration",
           "param_count"]

#: the four image feeds
FEEDS = ("input_A", "input_B", "fake_pool_A", "fake_pool_B")


@dataclasses.dataclass(frozen=True)
class CycleGANConfig:
    image_size: int = 256
    batch: int = 1
    ngf: int = 32                # the generator's base channels
    ndf: int = 64                # the discriminator's base channels
    n_blocks: int = 9
    lr: float = 2e-4
    beta1: float = 0.5
    beta2: float = 0.999
    lambda_A: float = 10.0
    lambda_B: float = 10.0
    lambda_identity: float = 0.5
    pool_size: int = 50
    init_std: float = 0.02


def cyclegan_256():
    """The source's configuration: 256^2, batch 1, ngf 32, ndf 64, 9
    blocks."""
    return CycleGANConfig()


def cyclegan_tiny(**kw):
    """32^2, batch 1, ngf 4, ndf 8, 2 residual blocks."""
    return dataclasses.replace(CycleGANConfig(
        image_size=32, batch=1, ngf=4, ndf=8, n_blocks=2), **kw)


def _instance_norm(pt, x, name):
    c = int(x.shape[1])
    scale = pt.layers.create_parameter(
        [c], "float32", attr=pt.ParamAttr(
            name=f"{name}_scale",
            initializer=pt.initializer.TruncatedNormal(1.0, 0.02)))
    offset = pt.layers.create_parameter(
        [c], "float32", attr=pt.ParamAttr(
            name=f"{name}_offset",
            initializer=pt.initializer.Constant(0.0)))
    return pt.layers.instance_norm(x, scale=scale, bias=offset,
                                   epsilon=1e-5)


def _attrs(pt, cfg, name, bias):
    w = pt.ParamAttr(name=f"{name}_w",
                     initializer=pt.initializer.Normal(0.0, cfg.init_std))
    b = pt.ParamAttr(name=f"{name}_b",
                     initializer=pt.initializer.Constant(0.0)) \
        if bias else False
    return w, b


def _conv(pt, cfg, x, filters, k, stride, pad, name, norm=True, act="relu"):
    """base_network.conv2d: a conv (a bias only where no norm follows),
    instance norm, then ``act`` ("relu", "leaky_relu" at 0.2, or None)."""
    w, b = _attrs(pt, cfg, name, not norm)
    x = pt.layers.conv2d(x, filters, k, stride=stride, padding=pad,
                         param_attr=w, bias_attr=b)
    if norm:
        x = _instance_norm(pt, x, f"{name}_norm")
    if act == "relu":
        return pt.layers.relu(x)
    if act == "leaky_relu":
        return pt.layers.leaky_relu(x, alpha=0.2)
    return x


def _deconv(pt, cfg, x, filters, name):
    """base_network.deconv2d as the generator calls it: a 3x3/2 transposed
    conv with padding 1, a constant pad of [0, 1, 0, 1], instance norm,
    ReLU."""
    w, _ = _attrs(pt, cfg, name, False)
    x = pt.layers.conv2d_transpose(x, filters, filter_size=3, stride=2,
                                   padding=1, param_attr=w, bias_attr=False)
    x = pt.layers.pad2d(x, [0, 1, 0, 1], mode="constant", pad_value=0.0)
    return pt.layers.relu(_instance_norm(pt, x, f"{name}_norm"))


def build_generator_resnet_9blocks(pt, cfg, x, name):
    """The ResNet generator (``n_blocks`` residual blocks) of ``x``
    [B, 3, S, S] into [B, 3, S, S] in (-1, 1); parameters ``{name}_*``."""
    L, g = pt.layers, cfg.ngf
    x = L.pad2d(x, [3, 3, 3, 3], mode="reflect")
    x = _conv(pt, cfg, x, g, 7, 1, 0, f"{name}_c1")
    x = _conv(pt, cfg, x, 2 * g, 3, 2, 1, f"{name}_c2")
    x = _conv(pt, cfg, x, 4 * g, 3, 2, 1, f"{name}_c3")
    for i in range(cfg.n_blocks):
        r = L.pad2d(x, [1, 1, 1, 1], mode="reflect")
        r = _conv(pt, cfg, r, 4 * g, 3, 1, 0, f"{name}_r{i + 1}_c1")
        r = L.pad2d(r, [1, 1, 1, 1], mode="reflect")
        r = _conv(pt, cfg, r, 4 * g, 3, 1, 0, f"{name}_r{i + 1}_c2",
                  act=None)
        x = L.elementwise_add(r, x)
    x = _deconv(pt, cfg, x, 2 * g, f"{name}_c4")
    x = _deconv(pt, cfg, x, g, f"{name}_c5")
    x = L.pad2d(x, [3, 3, 3, 3], mode="reflect")
    x = _conv(pt, cfg, x, 3, 7, 1, 0, f"{name}_c6", norm=False, act=None)
    return L.tanh(x)


def build_gen_discriminator(pt, cfg, x, name):
    """The 70x70 PatchGAN of ``x`` [B, 3, S, S]: [B, 1, P, P] logits (P = 30
    at 256^2); parameters ``{name}_*``."""
    d = cfg.ndf
    x = _conv(pt, cfg, x, d, 4, 2, 1, f"{name}_c1", norm=False,
              act="leaky_relu")
    x = _conv(pt, cfg, x, 2 * d, 4, 2, 1, f"{name}_c2", act="leaky_relu")
    x = _conv(pt, cfg, x, 4 * d, 4, 2, 1, f"{name}_c3", act="leaky_relu")
    x = _conv(pt, cfg, x, 8 * d, 4, 1, 1, f"{name}_c4", act="leaky_relu")
    return _conv(pt, cfg, x, 1, 4, 1, 1, f"{name}_c5", norm=False, act=None)


def _l1(pt, a, b, weight):
    L = pt.layers
    return L.scale(L.reduce_mean(L.abs(L.elementwise_sub(a, b))),
                   scale=weight)


def _mse_to(pt, x, target):
    """mean((x - target)^2) for target 0 or 1."""
    L = pt.layers
    if target:
        x = L.scale(x, bias=-float(target))
    return L.reduce_mean(L.square(x))


def _params(program, *prefixes):
    return [p.name for p in program.all_parameters()
            if p.name.startswith(prefixes)]


def build_train(pt, cfg):
    """The three training programs and the inference program, over one
    startup program. ``pt`` is ``paddle_tpu_torch`` (or the JAX package).
    Feeds: ``input_A``, ``input_B``, ``fake_pool_A``, ``fake_pool_B``, each
    [B, 3, S, S] fp32. Returns a dict: startup, main (G), d_a, d_b, infer,
    their losses (g_loss, d_a_loss, d_b_loss, and G's parts g_gan,
    cyc_loss, idt_loss), fake_A and fake_B (G's and the inference
    program's fetches), cyc_A and cyc_B, and the parameter names each
    optimizer updates (g_params, d_a_params, d_b_params)."""
    L = pt.layers
    S = cfg.image_size
    main, startup = pt.Program(), pt.Program()
    out = {"startup": startup}
    with pt.program_guard(main, startup), pt.framework.unique_name.guard():
        for n in FEEDS:
            pt.data(n, [3, S, S], "float32")

        def adam(name):
            return pt.optimizer.Adam(learning_rate=cfg.lr, beta1=cfg.beta1,
                                     beta2=cfg.beta2, name=name)

        g = main.clone()
        with pt.program_guard(g, startup):
            var = g.global_block().var
            real_A, real_B = var("input_A"), var("input_B")
            fake_B = build_generator_resnet_9blocks(pt, cfg, real_A, "g_A")
            fake_A = build_generator_resnet_9blocks(pt, cfg, real_B, "g_B")
            out["infer"] = g.clone(for_test=True)
            cyc_A = build_generator_resnet_9blocks(pt, cfg, fake_B, "g_B")
            cyc_B = build_generator_resnet_9blocks(pt, cfg, fake_A, "g_A")
            cyc_loss = L.elementwise_add(
                _l1(pt, real_A, cyc_A, cfg.lambda_A),
                _l1(pt, real_B, cyc_B, cfg.lambda_B))
            g_gan = L.elementwise_add(
                _mse_to(pt, build_gen_discriminator(pt, cfg, fake_B, "d_A"),
                        1),
                _mse_to(pt, build_gen_discriminator(pt, cfg, fake_A, "d_B"),
                        1))
            idt_A = build_generator_resnet_9blocks(pt, cfg, real_B, "g_A")
            idt_B = build_generator_resnet_9blocks(pt, cfg, real_A, "g_B")
            idt_loss = L.elementwise_add(
                _l1(pt, real_B, idt_A, cfg.lambda_B * cfg.lambda_identity),
                _l1(pt, real_A, idt_B, cfg.lambda_A * cfg.lambda_identity))
            g_loss = L.elementwise_add(L.elementwise_add(cyc_loss, g_gan),
                                       idt_loss)
            out["g_params"] = _params(g, "g_A", "g_B")
            adam("net_G").minimize(g_loss, parameter_list=out["g_params"])
        out.update(main=g, g_loss=g_loss, g_gan=g_gan, cyc_loss=cyc_loss,
                   idt_loss=idt_loss, fake_A=fake_A, fake_B=fake_B,
                   cyc_A=cyc_A, cyc_B=cyc_B)

        for key, real, pool, tag in (("d_a", "input_B", "fake_pool_B", "d_A"),
                                     ("d_b", "input_A", "fake_pool_A",
                                      "d_B")):
            d = main.clone()
            with pt.program_guard(d, startup):
                var = d.global_block().var
                rec = build_gen_discriminator(pt, cfg, var(real), tag)
                fake_rec = build_gen_discriminator(pt, cfg, var(pool), tag)
                loss = L.reduce_mean(L.scale(L.elementwise_add(
                    L.square(fake_rec), L.square(L.scale(rec, bias=-1.0))),
                    scale=0.5))
                out[f"{key}_params"] = _params(d, tag)
                adam(f"net_{tag.replace('_', '').upper()}").minimize(
                    loss, parameter_list=out[f"{key}_params"])
            out[key], out[f"{key}_loss"] = d, loss
    return out


class ImagePool:
    """trainer/CycleGAN.py's ImagePool: the first ``pool_size`` batches of
    fakes go in and come back as they are; after that, with probability
    one half, a stored batch comes back and the new one takes its place."""

    def __init__(self, pool_size=50, seed=0):
        self.pool_size = pool_size
        self.pool = []
        self.rng = np.random.RandomState(seed)

    def pool_image(self, image):
        if len(self.pool) < self.pool_size:
            self.pool.append(image)
            return image
        if self.rng.random_sample() > 0.5:
            i = self.rng.randint(0, self.pool_size)
            old, self.pool[i] = self.pool[i], image
            return old
        return image


def synthetic_images(cfg, batch, seed):
    """Unpaired images of the two domains from ``seed``, [B, 3, S, S] fp32
    in [-1, 1]: domain A smooth colour gradients with noise, domain B
    stripes with noise."""
    rng = np.random.RandomState(seed)
    S = cfg.image_size
    yy, xx = np.meshgrid(np.linspace(-1, 1, S), np.linspace(-1, 1, S),
                         indexing="ij")
    a = np.empty((batch, 3, S, S))
    b = np.empty((batch, 3, S, S))
    for i in range(batch):
        w = rng.uniform(-1, 1, (3, 2))
        a[i] = w[:, :1, None] * yy + w[:, 1:, None] * xx
        f = rng.uniform(2, 8, 3)
        b[i] = np.sin(f[:, None, None] * np.pi * (yy + xx)
                      + rng.uniform(0, np.pi, (3, 1, 1)))
    a += rng.normal(0, 0.1, a.shape)
    b += rng.normal(0, 0.1, b.shape)
    return (np.clip(a, -1, 1).astype(np.float32),
            np.clip(b, -1, 1).astype(np.float32))


def train_iteration(exe, built, scope, image_A, image_B, pools):
    """One iteration of the source's loop: G on (A, B), the fakes through
    the pools (``pools``: {"A": ImagePool, "B": ImagePool}; the fakes come
    back to the host, as the source fetches them), then D_A on (B, pooled
    fake B) and D_B on (A, pooled fake A). Returns (g_loss, d_a_loss,
    d_b_loss) as numpy scalars."""
    g_loss, fake_A, fake_B = exe.run(
        built["main"], feed={"input_A": image_A, "input_B": image_B},
        fetch_list=[built["g_loss"], built["fake_A"], built["fake_B"]],
        scope=scope)
    pool_B = pools["B"].pool_image(np.asarray(fake_B))
    pool_A = pools["A"].pool_image(np.asarray(fake_A))
    (d_a,) = exe.run(built["d_a"], feed={"input_B": image_B,
                                         "fake_pool_B": pool_B},
                     fetch_list=[built["d_a_loss"]], scope=scope)
    (d_b,) = exe.run(built["d_b"], feed={"input_A": image_A,
                                         "fake_pool_A": pool_A},
                     fetch_list=[built["d_b_loss"]], scope=scope)
    return np.asarray(g_loss), np.asarray(d_a), np.asarray(d_b)


def param_count(program, names):
    """The number of values in the parameters ``names`` of ``program``."""
    blk = program.global_block()
    return sum(int(np.prod(blk.var(n).shape)) for n in names)
