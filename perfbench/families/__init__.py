"""How a model family builds the program's config and lists its leaves.
``perfbench/families/<family>.py`` is found by the ``family`` of a
configuration's file."""
