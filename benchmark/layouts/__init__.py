"""The model layouts the benchmark takes, one module each, found by a
configuration's ``MODEL.NAME`` (``manifest.layout``):
``layouts/<MODEL.NAME>.py``. A layout module gives

- ``arch_from_file(path)``: the configuration's shapes, an ``Arch`` with
  ``embed``, ``resolution``, ``context``, ``vocab``, ``text_width``,
  ``text_heads``, ``text_layers``, ``width``, ``heads``, ``seq``,
  ``attention_blocks`` (the image-tower blocks that run the attention
  core) and ``image_flops()`` (one image's operations, ``flops.py``);
- ``param_layout(a)``: the port's parameter names, shapes and draws
  (``reference.draw_params`` draws them);
- ``zero_shot_logits(params, a, images_u8, classifier, prec)``: the plain
  float32 reference of the eval step;
- optionally ``train_reference(params, a, config_path, steps_per_epoch,
  prec, fault)``: the plain train step; the train kind refuses a layout
  without one.
"""
