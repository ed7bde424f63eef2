"""Execution strategies of the port: streamed execution (cuSten's
``nStreams``) for the 2D and batched-1D paths."""
