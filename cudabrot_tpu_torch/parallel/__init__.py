"""Multi-device and multi-process rendering: the data-parallel engine
(``data_parallel``), the row-sharded histogram engine (``sharded_hist``),
their device lists (``mesh``), the process group (``distributed``) and a
two-pass check of all of them at tiny shapes (``dryrun``)."""
