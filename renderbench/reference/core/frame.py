"""FrameParams: the per-frame configuration plane (port of
lsr_tpu/core/frame.py).

Every block of lsr_tpu's is here with its defaults: the raster route
(raster_*, use_tiled_raster, compact_*), the lighting (technique,
shading_model, debug_view, shadow.sun_vis_scale), the sun and local shadow
maps, the per-frame cull, the post passes (motion blur, light shafts, depth
of field, TAA, bloom), tonemap, FXAA and the background.
"""

from __future__ import annotations

import dataclasses
import enum


class TechniqueMode(enum.IntFlag):
    """Rendering technique bitmask (technique_mode.hpp:19-61)."""

    NONE = 0
    FORWARD = 1
    FORWARD_PLUS = 2
    DEFERRED = 4
    TILED_DEFERRED = 8
    CLUSTERED_FORWARD = 16
    ALL = 31


class DebugViewMode(enum.Enum):
    NONE = "none"
    ALBEDO = "albedo"
    NORMAL = "normal"
    DEPTH = "depth"


class LightCullingMode(enum.Enum):
    NONE = "none"
    TILED = "tiled"
    TILED_DEPTH_RANGE = "tiled_depth_range"
    CLUSTERED = "clustered"


@dataclasses.dataclass
class TonemapParams:
    exposure: float = 1.0
    gamma: float = 2.2


@dataclasses.dataclass
class ShadowPassParams:
    map_size: int = 2048
    bias_const: float = 0.0008
    bias_slope: float = 0.0015
    pcf_radius: int = 2
    pcf_step: int = 1
    strength: float = 1.0
    filter_mode: str = "pcf"
    sun_vis_scale: int = 1


@dataclasses.dataclass
class MotionBlurParams:
    samples: int = 8
    strength: float = 1.0
    depth_reject: float = 0.02
    target_dt: float = 1.0 / 60.0


@dataclasses.dataclass
class LightShaftsParams:
    steps: int = 48
    density: float = 0.9
    decay: float = 0.94
    weight: float = 0.35
    exposure: float = 0.25
    luma_threshold: float = 0.55


@dataclasses.dataclass
class DepthOfFieldParams:
    focus_depth: float = -1.0  # < 0: autofocus on the median center depth
    focus_range: float = 0.08
    blur_radius: int = 4


@dataclasses.dataclass
class TaaParams:
    blend: float = 0.1
    clamp_neighborhood: bool = True


@dataclasses.dataclass
class BloomParams:
    threshold: float = 1.0
    intensity: float = 0.5
    blur_passes: int = 3


@dataclasses.dataclass
class LocalShadowParams:
    """The local shadow atlas (lsr_tpu/core/frame.py:105-147).  spot_ids /
    point_ids are the budgeted casters (lighting.local_shadows.
    plan_shadow_casters); vis_crop is the planes' crop cascade (each plane
    evaluated in the smallest level that holds its light's footprint,
    lighting.local_shadows.vis_windows_plain)."""
    enabled: bool = True
    spot_ids: tuple = ()
    point_ids: tuple = ()
    map_size: int = 1024
    point_size: int = 512
    pcf_radius: int = 2
    bias_const: float = 2e-3
    bias_slope: float = 6e-3
    filter_mode: str = "pcf"
    vis_scale: int = 1
    vis_crop: tuple = ()


@dataclasses.dataclass
class CullingPassParams:
    """Per-frame scene and light culling (lsr_tpu/core/frame.py:150-162):
    frustum, the occluder depth proxy, the visibility hysteresis."""
    frustum: bool = True
    occlusion: bool = True
    occ_width: int = 320
    occ_height: int = 180
    hold_frames: int = 4
    cull_lights: bool = True


@dataclasses.dataclass
class PassParamBlocks:
    tonemap: TonemapParams = dataclasses.field(default_factory=TonemapParams)
    shadow: ShadowPassParams = dataclasses.field(
        default_factory=ShadowPassParams)
    motion_blur: MotionBlurParams = dataclasses.field(
        default_factory=MotionBlurParams)
    light_shafts: LightShaftsParams = dataclasses.field(
        default_factory=LightShaftsParams)
    dof: DepthOfFieldParams = dataclasses.field(
        default_factory=DepthOfFieldParams)
    taa: TaaParams = dataclasses.field(default_factory=TaaParams)
    bloom: BloomParams = dataclasses.field(default_factory=BloomParams)
    local_shadow: LocalShadowParams = dataclasses.field(
        default_factory=LocalShadowParams)
    culling: CullingPassParams = dataclasses.field(
        default_factory=CullingPassParams)


@dataclasses.dataclass
class TechniqueParams:
    mode: TechniqueMode = TechniqueMode.FORWARD
    depth_prepass: bool = False
    light_culling: LightCullingMode = LightCullingMode.NONE
    tile_size: int = 16
    max_lights_per_tile: int = 128
    cluster_slices: int = 16


@dataclasses.dataclass
class FrameParams:
    width: int = 1280
    height: int = 720
    dt: float = 1.0 / 60.0
    time: float = 0.0

    enable_shadows: bool = True
    enable_motion_vectors: bool = False
    enable_motion_blur: bool = False
    enable_light_shafts: bool = False
    enable_dof: bool = False
    enable_fxaa: bool = False
    enable_taa: bool = False
    enable_bloom: bool = False
    enable_ibl: bool = False

    debug_view: DebugViewMode = DebugViewMode.NONE
    shading_model: str = "pbr_mr"
    cull_mode: int = 1  # CULL_BACK

    pass_params: PassParamBlocks = dataclasses.field(
        default_factory=PassParamBlocks)
    technique: TechniqueParams = dataclasses.field(
        default_factory=TechniqueParams)

    # Raster route: the binned kernel's tile / list cap / chunk, and the
    # density switch to the compact geometry front-end.
    raster_tile_h: int = 64
    raster_tile_w: int = 128
    raster_cap: int = 1024
    raster_chunk: int = 16
    use_tiled_raster: bool = True
    compact_setup_threshold: int = 300_000
    compact_cap_fraction: float = 0.62

    background: tuple = (0.04, 0.06, 0.1)
