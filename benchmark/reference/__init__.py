"""The plain reference: `plain`, the model's step, adjoint and optimiser
written from its definitions; `tslref`, a frozen copy of the port's scene
definitions; and `scenes.make`, which builds a configuration's scene with
that copy."""
