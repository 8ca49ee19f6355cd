"""The benchmark's plain reference: float32 PyTorch (TF32 off) that works
out again what the program under test derives, from the same inputs. It
imports nothing of the program, of JAX or of the JAX package.

A configuration's ``network`` names a module ``reference/<network>.py``
that holds everything the harness knows of that PPO2 policy network:

* ``FRAMES``: whether the program's observations are uint8 frames (the
  faults that alter a frame apply only then, and ``frame_gap`` reads a
  share of frame values; otherwise the widest gap over the observations'
  root mean square);
* ``param_shapes(cfg)``: {name: shape} of every leaf, from the
  configuration alone: the policy's, which the program's ``state_dict``
  must hold under the same names, and those of a frozen stage that lives in
  the program's env (an SRL encoder, a PCA);
* ``trained(name)``: whether the optimizer steps the leaf (a frozen
  stage's are not judged as gradients);
* ``init_params(shapes, seed, device)``: every leaf drawn from ``seed`` on
  ``device``;
* ``observe(env, state, params)``: the program's observation of the
  reference env's ``state`` (the env's own for pixels and ground truth; the
  frozen stage applied to it for an encoded env);
* ``forward(params, obs, cfg, precision, magnitude=False)``: (logits,
  values) of observations as the policy gets them (normalized where the
  configuration's ``normalize_obs`` says so), and with ``magnitude`` the
  value head's magnitude, the sum of |weight x feature| over its inputs and
  |bias|; ``precision="fp8"`` is the control.

The trained leaves reach the program through its fine-tuning start
(``agent.pretrained``); a frozen stage reaches the program's env through
``handin/<network>.py``, which may import the program and so lives outside
this package."""
