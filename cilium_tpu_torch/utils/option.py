"""The one runtime-option name the port needs, copied from
``cilium_tpu/utils/option.py`` (the option map itself is not part of the
port yet)."""

OPTION_POLICY_VERDICT_NOTIFY = "PolicyVerdictNotification"
