"""The launch layer for the dense LM: input shapes (``shapes``), the
serving step functions (``steps``) and the serving CLI (``serve``)."""
