"""Wire models (the ``@ channel`` registry; only ``ideal`` runs)."""
