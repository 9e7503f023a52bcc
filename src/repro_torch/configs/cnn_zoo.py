"""The paper's own benchmark workloads: CNN layer-dimension tables (a copy
of the JAX package's ``configs/cnn_zoo.py``).

FlexNN is evaluated on ResNet50/101, YOLOv2, MobileNetV2, GoogLeNet and
InceptionV3 (§IV).  The energy-model reproduction needs per-layer conv
dimensions; these are generated from the published architectures.

Each layer is a ``ConvLayer`` (see ``repro_torch.core.energy_model``): output
spatial dims OX×OY, channels IC→OC, filter FX×FY, stride, groups (depthwise
convs use groups == IC).
"""
from __future__ import annotations

from repro_torch.core.energy_model import ConvLayer


def _c(name, ox, ic, oc, f, stride=1, groups=1, oy=None):
    return ConvLayer(name=name, ox=ox, oy=oy if oy is not None else ox,
                     oc=oc, ic=ic, fx=f, fy=f, stride=stride, groups=groups)


# ---------------------------------------------------------------------------
# ResNet-50 / ResNet-101 (bottleneck stages; ImageNet 224x224)
# ---------------------------------------------------------------------------

def _resnet(blocks_per_stage) -> list[ConvLayer]:
    layers = [_c("conv1", 112, 3, 64, 7, stride=2)]
    stage_cfg = [  # (spatial, mid_channels, out_channels)
        (56, 64, 256), (28, 128, 512), (14, 256, 1024), (7, 512, 2048)]
    in_ch = 64
    for s, (n_blocks, (sp, mid, out)) in enumerate(zip(blocks_per_stage, stage_cfg)):
        for b in range(n_blocks):
            stride = 2 if (b == 0 and s > 0) else 1
            pre = f"conv{s+2}_{b+1}"
            layers.append(_c(f"{pre}.a", sp, in_ch, mid, 1, stride=stride))
            layers.append(_c(f"{pre}.b", sp, mid, mid, 3))
            layers.append(_c(f"{pre}.c", sp, mid, out, 1))
            if b == 0:  # projection shortcut
                layers.append(_c(f"{pre}.ds", sp, in_ch, out, 1, stride=stride))
            in_ch = out
    layers.append(_c("fc", 1, 2048, 1000, 1))
    return layers


def resnet50() -> list[ConvLayer]:
    return _resnet([3, 4, 6, 3])


def resnet101() -> list[ConvLayer]:
    return _resnet([3, 4, 23, 3])


# ---------------------------------------------------------------------------
# YOLOv2 (Darknet-19 backbone + detection head, 416x416)
# ---------------------------------------------------------------------------

def yolov2() -> list[ConvLayer]:
    L = []
    L.append(_c("conv1", 416, 3, 32, 3))
    L.append(_c("conv2", 208, 32, 64, 3))
    L.append(_c("conv3", 104, 64, 128, 3))
    L.append(_c("conv4", 104, 128, 64, 1))
    L.append(_c("conv5", 104, 64, 128, 3))
    L.append(_c("conv6", 52, 128, 256, 3))
    L.append(_c("conv7", 52, 256, 128, 1))
    L.append(_c("conv8", 52, 128, 256, 3))
    L.append(_c("conv9", 26, 256, 512, 3))
    L.append(_c("conv10", 26, 512, 256, 1))
    L.append(_c("conv11", 26, 256, 512, 3))
    L.append(_c("conv12", 26, 512, 256, 1))
    L.append(_c("conv13", 26, 256, 512, 3))
    L.append(_c("conv14", 13, 512, 1024, 3))
    L.append(_c("conv15", 13, 1024, 512, 1))
    L.append(_c("conv16", 13, 512, 1024, 3))
    L.append(_c("conv17", 13, 1024, 512, 1))
    L.append(_c("conv18", 13, 512, 1024, 3))
    L.append(_c("conv19", 13, 1024, 1024, 3))
    L.append(_c("conv20", 13, 1024, 1024, 3))
    L.append(_c("conv21_pass", 26, 512, 64, 1))       # passthrough 1x1
    L.append(_c("conv21", 13, 1024 + 256, 1024, 3))   # 64ch reorg -> 256
    L.append(_c("conv22", 13, 1024, 425, 1))
    return L


# ---------------------------------------------------------------------------
# MobileNetV2 (inverted residuals; t = expansion)
# ---------------------------------------------------------------------------

def mobilenet_v2() -> list[ConvLayer]:
    L = [_c("conv0", 112, 3, 32, 3, stride=2)]
    spec = [  # (t, c_out, n, stride) at input spatial after stem
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    sp, in_ch = 112, 32
    idx = 1
    for t, c, n, s in spec:
        for b in range(n):
            stride = s if b == 0 else 1
            out_sp = sp // stride
            hid = in_ch * t
            if t != 1:
                L.append(_c(f"ir{idx}.expand", sp, in_ch, hid, 1))
            L.append(_c(f"ir{idx}.dw", out_sp, hid, hid, 3, stride=stride,
                        groups=hid))
            L.append(_c(f"ir{idx}.project", out_sp, hid, c, 1))
            sp, in_ch = out_sp, c
            idx += 1
    L.append(_c("conv_last", 7, 320, 1280, 1))
    L.append(_c("fc", 1, 1280, 1000, 1))
    return L


# ---------------------------------------------------------------------------
# GoogLeNet (Inception v1) — 9 inception modules
# ---------------------------------------------------------------------------

def googlenet() -> list[ConvLayer]:
    L = [
        _c("conv1", 112, 3, 64, 7, stride=2),
        _c("conv2.red", 56, 64, 64, 1),
        _c("conv2", 56, 64, 192, 3),
    ]
    # (spatial, in, 1x1, 3x3red, 3x3, 5x5red, 5x5, pool_proj)
    modules = [
        ("3a", 28, 192, 64, 96, 128, 16, 32, 32),
        ("3b", 28, 256, 128, 128, 192, 32, 96, 64),
        ("4a", 14, 480, 192, 96, 208, 16, 48, 64),
        ("4b", 14, 512, 160, 112, 224, 24, 64, 64),
        ("4c", 14, 512, 128, 128, 256, 24, 64, 64),
        ("4d", 14, 512, 112, 144, 288, 32, 64, 64),
        ("4e", 14, 528, 256, 160, 320, 32, 128, 128),
        ("5a", 7, 832, 256, 160, 320, 32, 128, 128),
        ("5b", 7, 832, 384, 192, 384, 48, 128, 128),
    ]
    for nm, sp, cin, c1, c3r, c3, c5r, c5, cp in modules:
        L.append(_c(f"inc{nm}.1x1", sp, cin, c1, 1))
        L.append(_c(f"inc{nm}.3x3red", sp, cin, c3r, 1))
        L.append(_c(f"inc{nm}.3x3", sp, c3r, c3, 3))
        L.append(_c(f"inc{nm}.5x5red", sp, cin, c5r, 1))
        L.append(_c(f"inc{nm}.5x5", sp, c5r, c5, 5))
        L.append(_c(f"inc{nm}.pool", sp, cin, cp, 1))
    L.append(_c("fc", 1, 1024, 1000, 1))
    return L


# ---------------------------------------------------------------------------
# InceptionV3 (299x299; factorized convs, torchvision structure)
# ---------------------------------------------------------------------------

def inception_v3() -> list[ConvLayer]:
    L = [
        _c("Conv2d_1a", 149, 3, 32, 3, stride=2),
        _c("Conv2d_2a", 147, 32, 32, 3),
        _c("Conv2d_2b", 147, 32, 64, 3),
        _c("Conv2d_3b", 73, 64, 80, 1),
        _c("Conv2d_4a", 71, 80, 192, 3),
    ]

    def mixed_a(nm, sp, cin, pool_ch):
        return [
            _c(f"{nm}.1x1", sp, cin, 64, 1),
            _c(f"{nm}.5x5red", sp, cin, 48, 1),
            _c(f"{nm}.5x5", sp, 48, 64, 5),
            _c(f"{nm}.3x3red", sp, cin, 64, 1),
            _c(f"{nm}.3x3a", sp, 64, 96, 3),
            _c(f"{nm}.3x3b", sp, 96, 96, 3),
            _c(f"{nm}.pool", sp, cin, pool_ch, 1),
        ]

    L += mixed_a("Mixed_5b", 35, 192, 32)
    L += mixed_a("Mixed_5c", 35, 256, 64)
    L += mixed_a("Mixed_5d", 35, 288, 64)
    # Mixed_6a (grid reduction)
    L += [
        _c("Mixed_6a.3x3", 17, 288, 384, 3, stride=2),
        _c("Mixed_6a.dred", 35, 288, 64, 1),
        _c("Mixed_6a.d3a", 35, 64, 96, 3),
        _c("Mixed_6a.d3b", 17, 96, 96, 3, stride=2),
    ]

    def mixed_b(nm, c7):  # 17x17, factorized 7x1/1x7
        sp, cin = 17, 768
        out = []
        out.append(_c(f"{nm}.1x1", sp, cin, 192, 1))
        out.append(_c(f"{nm}.7red", sp, cin, c7, 1))
        out.append(ConvLayer(f"{nm}.1x7a", ox=sp, oy=sp, oc=c7, ic=c7, fx=1, fy=7))
        out.append(ConvLayer(f"{nm}.7x1a", ox=sp, oy=sp, oc=192, ic=c7, fx=7, fy=1))
        out.append(_c(f"{nm}.dred", sp, cin, c7, 1))
        out.append(ConvLayer(f"{nm}.7x1b", ox=sp, oy=sp, oc=c7, ic=c7, fx=7, fy=1))
        out.append(ConvLayer(f"{nm}.1x7b", ox=sp, oy=sp, oc=c7, ic=c7, fx=1, fy=7))
        out.append(ConvLayer(f"{nm}.7x1c", ox=sp, oy=sp, oc=c7, ic=c7, fx=7, fy=1))
        out.append(ConvLayer(f"{nm}.1x7c", ox=sp, oy=sp, oc=192, ic=c7, fx=1, fy=7))
        out.append(_c(f"{nm}.pool", sp, cin, 192, 1))
        return out

    L += mixed_b("Mixed_6b", 128)
    L += mixed_b("Mixed_6c", 160)
    L += mixed_b("Mixed_6d", 160)
    L += mixed_b("Mixed_6e", 192)
    # Mixed_7a (grid reduction)
    L += [
        _c("Mixed_7a.3red", 17, 768, 192, 1),
        _c("Mixed_7a.3x3", 8, 192, 320, 3, stride=2),
        _c("Mixed_7a.7red", 17, 768, 192, 1),
        ConvLayer("Mixed_7a.1x7", ox=17, oy=17, oc=192, ic=192, fx=1, fy=7),
        ConvLayer("Mixed_7a.7x1", ox=17, oy=17, oc=192, ic=192, fx=7, fy=1),
        _c("Mixed_7a.3x3b", 8, 192, 192, 3, stride=2),
    ]

    def mixed_c(nm, cin):  # 8x8 expanded 3x1/1x3 branches
        sp = 8
        return [
            _c(f"{nm}.1x1", sp, cin, 320, 1),
            _c(f"{nm}.3red", sp, cin, 384, 1),
            ConvLayer(f"{nm}.1x3a", ox=sp, oy=sp, oc=384, ic=384, fx=1, fy=3),
            ConvLayer(f"{nm}.3x1a", ox=sp, oy=sp, oc=384, ic=384, fx=3, fy=1),
            _c(f"{nm}.dred", sp, cin, 448, 1),
            _c(f"{nm}.d3x3", sp, 448, 384, 3),
            ConvLayer(f"{nm}.1x3b", ox=sp, oy=sp, oc=384, ic=384, fx=1, fy=3),
            ConvLayer(f"{nm}.3x1b", ox=sp, oy=sp, oc=384, ic=384, fx=3, fy=1),
            _c(f"{nm}.pool", sp, cin, 192, 1),
        ]

    L += mixed_c("Mixed_7b", 1280)
    L += mixed_c("Mixed_7c", 2048)
    L.append(_c("fc", 1, 2048, 1000, 1))
    return L


NETWORKS = {
    "resnet50": resnet50,
    "resnet101": resnet101,
    "yolov2": yolov2,
    "mobilenet_v2": mobilenet_v2,
    "googlenet": googlenet,
    "inception_v3": inception_v3,
}
