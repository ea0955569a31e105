"""TensorFlow/Keras re-derivation of the U-Net and the PatchGAN: the
second parity target of ``parity_check`` (``reference: "keras"``).

A copy of ``sequitr_tpu.models.tf_reference``: the same topology (SAME
padding, batch-norm semantics, transposed-conv geometry) rebuilt in Keras,
with weight injection from the nested (params, state) pytrees of the
interchange layout (``models.convert.nest_flat``), and the reference's CPU
throughput (``measure_tf_cpu_fps``: normalize + U-Net in TensorFlow on the
host's CPU).

TensorFlow is only imported inside functions; an ``ImportError`` there is
what ``parity_check`` reports as the reference being unavailable.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from sequitr_tpu_torch.models.unet import UNetConfig

__all__ = [
    "build_tf_unet", "build_tf_patchgan", "inject_weights", "inject_patchgan_weights",
    "tf_forward", "measure_tf_cpu_fps",
]


def build_tf_unet(cfg: UNetConfig, spatial):
    """Keras functional model mirroring the U-Net forward (2D and 3D)."""
    import tensorflow as tf

    if cfg.dims == 2:
        Conv, ConvT, Pool = (
            tf.keras.layers.Conv2D,
            tf.keras.layers.Conv2DTranspose,
            tf.keras.layers.MaxPool2D,
        )
    elif cfg.dims == 3:
        Conv, ConvT, Pool = (
            tf.keras.layers.Conv3D,
            tf.keras.layers.Conv3DTranspose,
            tf.keras.layers.MaxPool3D,
        )
    else:
        raise NotImplementedError(f"dims={cfg.dims}")

    def block(x, c, name):
        for i in (1, 2):
            x = Conv(c, 3, padding="same", use_bias=True, name=f"{name}_conv{i}")(x)
            if cfg.norm == "batch":
                x = tf.keras.layers.BatchNormalization(
                    momentum=cfg.bn_momentum, epsilon=cfg.bn_eps, name=f"{name}_bn{i}"
                )(x)
            x = tf.keras.layers.ReLU()(x)
        return x

    inp = tf.keras.Input(shape=tuple(spatial) + (cfg.in_channels,))
    x = inp
    skips = []
    for lvl in range(cfg.depth):
        if lvl > 0:
            x = Pool(2)(x)
        x = block(x, cfg.features(lvl), f"enc{lvl}")
        if lvl < cfg.depth - 1:
            skips.append(x)

    for i, lvl in enumerate(reversed(range(cfg.depth - 1))):
        c_skip = cfg.features(lvl)
        x = ConvT(c_skip, 2, strides=2, padding="valid", name=f"up{i}")(x)
        x = tf.keras.layers.Concatenate()([skips[lvl], x])
        x = block(x, c_skip, f"dec{i}")

    logits = Conv(cfg.num_classes, 1, name="head")(x)
    return tf.keras.Model(inp, logits)


def build_tf_patchgan(gcfg, spatial):
    """Keras mirror of the PatchGAN discriminator."""
    import tensorflow as tf

    inp = tf.keras.Input(
        shape=tuple(spatial) + (gcfg.in_channels + gcfg.out_channels,)
    )
    x = inp
    c = gcfg.disc_base_features
    for i in range(gcfg.disc_layers):
        x = tf.keras.layers.Conv2D(
            c, 4, strides=2, padding="same", name=f"disc_conv{i}"
        )(x)
        x = tf.keras.layers.LeakyReLU(0.2)(x)
        c = min(c * 2, 512)
    x = tf.keras.layers.Conv2D(c, 4, padding="same", name="disc_penult")(x)
    x = tf.keras.layers.LeakyReLU(0.2)(x)
    logits = tf.keras.layers.Conv2D(1, 4, padding="same", name="disc_head")(x)
    return tf.keras.Model(inp, logits)


def inject_patchgan_weights(model, gcfg, params) -> None:
    """Copy a GAN's nested discriminator pytree into the Keras PatchGAN."""

    def np32(a):
        return np.asarray(a, dtype=np.float32)

    disc = params["disc"]
    for i, p in enumerate(disc["convs"]):
        model.get_layer(f"disc_conv{i}").set_weights([np32(p["w"]), np32(p["b"])])
    model.get_layer("disc_penult").set_weights(
        [np32(disc["penultimate"]["w"]), np32(disc["penultimate"]["b"])]
    )
    model.get_layer("disc_head").set_weights(
        [np32(disc["head"]["w"]), np32(disc["head"]["b"])]
    )


def inject_weights(model, cfg: UNetConfig, params: Any, state: Any) -> None:
    """Copy a nested (params, state) pytree into the Keras model.

    Layout notes: our conv kernels are HWIO — identical to Keras Conv2D.
    Keras Conv2DTranspose kernels are (kh, kw, out, in): transpose of our
    last two axes. BN maps scale/bias/mean/var -> gamma/beta/moving stats.
    """

    def np32(a):
        return np.asarray(a, dtype=np.float32)

    def set_conv(layer_name, p):
        model.get_layer(layer_name).set_weights([np32(p["w"]), np32(p["b"])])

    def set_convT(layer_name, p):
        # Keras Conv{2,3}DTranspose kernels are (k..., c_out, c_in):
        # swap our trailing (c_in, c_out) axes
        w = np32(p["w"])
        axes = tuple(range(w.ndim - 2)) + (w.ndim - 1, w.ndim - 2)
        model.get_layer(layer_name).set_weights([w.transpose(axes), np32(p["b"])])

    def set_bn(layer_name, p, s):
        model.get_layer(layer_name).set_weights(
            [np32(p["scale"]), np32(p["bias"]), np32(s["mean"]), np32(s["var"])]
        )

    for lvl in range(cfg.depth):
        for i in (1, 2):
            set_conv(f"enc{lvl}_conv{i}", params["enc"][lvl][f"conv{i}"])
            if cfg.norm == "batch":
                set_bn(
                    f"enc{lvl}_bn{i}",
                    params["enc"][lvl][f"bn{i}"],
                    state["enc"][lvl][f"bn{i}"],
                )
    for i in range(cfg.depth - 1):
        set_convT(f"up{i}", params["up"][i])
        for j in (1, 2):
            set_conv(f"dec{i}_conv{j}", params["dec"][i][f"conv{j}"])
            if cfg.norm == "batch":
                set_bn(
                    f"dec{i}_bn{j}", params["dec"][i][f"bn{j}"], state["dec"][i][f"bn{j}"]
                )
    set_conv("head", params["head"])


def tf_forward(model, x: np.ndarray) -> np.ndarray:
    """Inference-mode forward -> logits (N, H, W, K) float32."""
    import tensorflow as tf

    return model(tf.convert_to_tensor(np.asarray(x, np.float32)), training=False).numpy()


def measure_tf_cpu_fps(
    frame: int = 1024, iters: int = 3, depth: int = 4, base_features: int = 32
) -> float:
    """Reference-equivalent CPU throughput in frames/s: the percentile
    normalize and the f32 Keras U-Net (random weights) on one ``frame``
    square frame, TensorFlow's GPUs hidden, after one warm-up call."""
    import time

    import tensorflow as tf

    tf.config.set_visible_devices([], "GPU")
    cfg = UNetConfig(
        in_channels=1, num_classes=3, depth=depth, base_features=base_features,
        compute_dtype="float32",
    )
    model = build_tf_unet(cfg, (frame, frame))
    rng = np.random.default_rng(0)
    x = rng.gamma(2.0, 100.0, (frame, frame)).astype(np.float32)

    def percentile(t, q):
        flat = tf.sort(tf.reshape(t, [-1]))
        n = tf.cast(tf.size(flat) - 1, tf.float32)
        return flat[tf.cast(tf.round(q / 100.0 * n), tf.int32)]

    @tf.function
    def run(img):
        lo = percentile(img, 5.0)
        hi = percentile(img, 99.5)
        norm = tf.clip_by_value((img - lo) / (hi - lo + 1e-8), 0.0, 1.0)
        logits = model(norm[None, :, :, None], training=False)
        return tf.argmax(logits[0], axis=-1)

    run(tf.convert_to_tensor(x)).numpy()  # trace + warm-up
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(tf.convert_to_tensor(x))
    _ = out.numpy()
    return iters / (time.perf_counter() - t0)
