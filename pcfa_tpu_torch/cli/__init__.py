"""Command-line runners: `python -m pcfa_tpu_torch.cli.attack_pcfa`,
`.attack_fgsm` and `.evaluate_pcfa`, with the JAX package's flags."""
