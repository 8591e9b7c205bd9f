"""Directional (sun) shadow-map pass (port of lsr_tpu/passes/shadow.py:
render_shadow_map and make_sun_shadow, :27-88).

The shadow casters' merged AABB fits the light camera (ortho, texel-
snapped); the casters' triangles go through the depth-only setup with no
backface culling and kernel B1 in DEPTH_NDC01 mode (z01 = z_ndc * 0.5 +
0.5, min-z resolve, no ids) on 128x128 tiles with the spatial sort, as
lsr_tpu renders its sun map (pass_shadow_map.hpp:143-202).
"""

from __future__ import annotations

from renderbench.reference.camera.light_camera import build_dir_light_camera
from renderbench.reference.lighting.shadow_sample import make_shadow_context
from renderbench.reference.raster.setup import (
    CULL_NONE,
    DEPTH_NDC01,
    scene_setup_depth,
)
from renderbench.reference.raster.tiled import rasterize_direct
from renderbench.reference.scene.scene import shadow_caster_aabb


def shadow_map_setup(geom, objects, sun_dir_ws, map_size: int = 2048,
                     depth_margin: float = 10.0):
    """The light camera and the casters' depth-only setup.
    Returns (TriSetup, light_viewproj (4, 4))."""
    smin, smax = shadow_caster_aabb(objects)
    _, _, light_vp = build_dir_light_camera(smin, smax, sun_dir_ws, map_size,
                                            depth_margin=depth_margin)
    setup = scene_setup_depth(
        geom.positions, geom.indices, geom.vtx_obj, geom.tri_obj,
        objects.model, light_vp, map_size, map_size, cull_mode=CULL_NONE,
        obj_visible=objects.casts_shadow & objects.visible)
    return setup, light_vp


def render_shadow_map(geom, objects, sun_dir_ws, map_size: int = 2048,
                      depth_margin: float = 10.0):
    """Returns (shadow_depth (S, S) f32, light_viewproj (4, 4))."""
    setup, light_vp = shadow_map_setup(geom, objects, sun_dir_ws, map_size,
                                       depth_margin)
    depth, _, _ = rasterize_direct(
        setup, map_size, map_size, 0.0, 1.0, depth_mode=DEPTH_NDC01,
        track_ids=False, tile_h=128, tile_w=128, spatial_sort=True)
    return depth, light_vp


def make_sun_shadow(geom, objects, sun_dir_ws, params):
    """Render the map and build its sampling context.
    params: core.frame.ShadowPassParams."""
    depth, light_vp = render_shadow_map(geom, objects, sun_dir_ws,
                                        map_size=params.map_size)
    return make_shadow_context(
        depth, light_vp, bias_const=params.bias_const,
        bias_slope=params.bias_slope, strength=params.strength,
        pcf_radius=params.pcf_radius, pcf_step=params.pcf_step,
        filter_mode=params.filter_mode)
