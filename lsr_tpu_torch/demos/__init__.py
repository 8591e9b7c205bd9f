"""The port's counterparts of lsr_tpu's demo entry points (demos/hello_*.py).

Each demo module splits into build_scene(mesh, device) (geometry, objects,
lights and shading context with lsr_tpu's constants), render(scene, width,
height, ...) (one frame: a dict with the LDR frame and its intermediates)
and main(argv), run as

    python -m lsr_tpu_torch.demos.hello_water [--device cuda|cpu]
        [--width W --height H] [--obj PATH] [--out DIR]

The mesh defaults to a procedural UV sphere standing in for lsr_tpu's
monkey; --obj loads an OBJ file instead.  Library modules never import
this package.
"""
