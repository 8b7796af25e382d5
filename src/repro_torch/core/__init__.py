"""Disaggregation core: compat components, KV transport, P→D pipeline."""
