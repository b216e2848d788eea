"""A frozen copy of thinshelllab_torch's scene definitions: the builder
(meshes, rest shapes, masses, hinge stencils, materials, contact pairs,
the gripper's pads), the tactile pad's mesh and the folding task's reward
and adjoint seed, as the port had them when the benchmark was defined.
The benchmark's reference (`../plain.py`) reads the scene's arrays from
here and computes everything else itself. It imports nothing of the
port, so a later change of the port's scenes is held against this copy.
The native topology helper is replaced by its numpy path.
"""
