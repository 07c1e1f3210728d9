"""Entry points: model loading, the offline eval (``make_eval``,
``deteval``, ``ioueval``) and the quality bench's evaluation."""
