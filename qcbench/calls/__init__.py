"""What a traffic mix's window drives, one file per kind of call.

A mix (``traffic/<mix>.json``) names its kind under ``call``; the harness
loads ``calls/<call>.py`` by that name (``harness.call_kind``).  A kind
module gives:

- ``names``: the numbers it compares, each with a limit in the cell's
  ``limits/<cell>.json``;
- ``bind(driver, inputs, cell)``: the timed call, a function of the
  call's index k (0, 1, ... through the warm-up and the window) whose
  return value the harness keeps;
- ``reference(inputs, config, limits, device)``: the plain reference's
  answer;
- ``numbers(out, ref)``: the numbers compared for one output;

and may give:

- ``make_inputs(config, traffic, seed, device)``: the inputs made from
  the seed, where the general generator (``qcbench/inputs.py``) does not
  make them;
- ``window_metrics(traffic, timeline, t0, outs)``: the end-to-end values
  of the window (besides ``setup_s``), where they are not the window's
  wall over its calls under the mix's ``per_call_metric``.

A mix that reuses a kind is data alone; a mix that needs a new kind adds
a file here and edits none.
"""
