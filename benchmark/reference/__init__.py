"""The benchmark's plain reference: the served models (``model``) and the exact OOD
metrics (``ood_metrics``).  Imports torch and nothing of the program under test."""
